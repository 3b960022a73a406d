"""Data of the port: synthetic pairs with exact ground-truth flow, the
per-item random draws and the resumable batch loader."""
