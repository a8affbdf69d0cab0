"""Configuration (copied from the JAX package) and device selection."""
