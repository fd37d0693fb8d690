"""The plain reference: exact search in plain PyTorch, the comparison
that decides ``correct``, and its control in a lower precision. Nothing
here imports the port or JAX."""
