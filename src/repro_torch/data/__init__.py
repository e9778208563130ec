"""Synthetic data pipelines of the port (NumPy, so a batch is the same
bit for bit as the reference's)."""
