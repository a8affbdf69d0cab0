"""Plain references of the port's models, written in plain PyTorch from the
published equations and importing nothing of the port: the CPU tests hold
the port's forwards against them."""
