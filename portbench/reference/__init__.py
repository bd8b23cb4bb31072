"""The plain reference of the metrics the cells run: float64 PyTorch
formulas, written from the metrics' definitions.  It imports nothing of
the port, of the JAX package or of JAX, and takes only the inputs the
benchmark made."""
