"""Training-side adapters of the port; for now the evaluation model."""
