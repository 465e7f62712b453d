"""Model definitions (the ADM UNet and the fork's CLIP-conditioned variant)."""
