"""Hand-written CUDA kernels (csrc/), their ctypes bindings and their
plain PyTorch versions."""
