"""Kernels, their plain PyTorch versions, and the tensor primitives
around them."""
