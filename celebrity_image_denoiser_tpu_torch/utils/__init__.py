"""Logging and nested-dict helpers (copied from the JAX package)."""
