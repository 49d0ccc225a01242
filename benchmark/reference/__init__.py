"""Plain references of the benchmark: PyTorch and NumPy only, nothing of the program."""
