"""Plain references the benchmark holds the program to: PyTorch, NumPy
and PIL only, nothing of the program under test."""
