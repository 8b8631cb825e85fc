"""Operators of the PyTorch port: activations, norms, initializers,
spectral operators and the hand-written CUDA kernels (ops/cuda)."""
