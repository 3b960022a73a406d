"""Data of the port: synthetic pairs with exact ground-truth flow."""
