"""Plain PyTorch references of what the benchmark runs; they import nothing
of the program."""
