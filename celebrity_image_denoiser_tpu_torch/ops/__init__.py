"""Operators: plain PyTorch ops (conv, pool) and the CUDA kernels."""
