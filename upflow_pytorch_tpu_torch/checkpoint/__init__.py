"""Weight loading: ``.npz`` snapshots of the JAX package -> state dicts."""
