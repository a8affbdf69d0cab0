"""Checkpoint readers: JAX param trees / npz and .pth into a torch state_dict."""
