"""Training on one GPU: the timestep samplers and ``TrainLoop``."""
