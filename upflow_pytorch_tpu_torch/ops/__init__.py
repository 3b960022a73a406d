"""Tensor ops of the port (NCHW): warps, resize, normalisation,
correlation; the CUDA kernels and their plain versions live in
``ops.kernels``."""
