"""The image data pipeline with CLIP-embedding pairing."""
