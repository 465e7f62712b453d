"""Scoring samples: the frozen FID InceptionV3 (``inception.py``) and the
FID / sFID / IS / precision-recall evaluator (``evaluator.py``), the port of
the repo's ``evaluations/``."""
