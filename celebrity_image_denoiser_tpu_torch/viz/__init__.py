"""Host-side figures: the per-request analysis figure, the training
plots and the per-epoch test images (matplotlib and PIL, imported on
use)."""
