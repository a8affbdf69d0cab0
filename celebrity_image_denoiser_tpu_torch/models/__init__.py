"""Models of the port (denoise U-Net generator so far)."""
