"""The plain reference the benchmark holds the port to: plain PyTorch,
NumPy and SciPy, importing nothing of the program."""
