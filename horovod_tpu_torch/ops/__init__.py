"""Collectives, reduction ops, compression markers and the CUDA attention
kernels of the port."""
