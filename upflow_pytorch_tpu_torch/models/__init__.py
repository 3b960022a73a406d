"""The UPFlow network as PyTorch modules."""
