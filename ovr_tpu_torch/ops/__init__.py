"""Hand-written kernels and their plain PyTorch versions."""
