"""Problem generators (NumPy)."""
