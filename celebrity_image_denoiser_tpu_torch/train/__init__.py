"""Training of the port: losses, optimiser, the GAN train step and loop."""
