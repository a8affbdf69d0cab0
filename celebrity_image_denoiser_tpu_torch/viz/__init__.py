"""Per-request analysis figure (matplotlib, imported on use)."""
