"""The hand-written Hopper kernels (``csrc/``) with their wrappers, launch
counts and plain PyTorch versions."""
