"""Hand-written CUDA kernels for Hopper, bound with ctypes, and their
plain PyTorch versions."""
