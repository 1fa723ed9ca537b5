"""Core utilities of the PyTorch port: config, masks, device policy."""
