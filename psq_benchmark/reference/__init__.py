"""A frozen copy of the port's host layer and plain PyTorch twins (no
kernel, no C++), with a NumPy Smith-Waterman: the benchmark's reference.
It imports nothing of the port."""
