"""The unsupervised losses of the training step (NCHW)."""
