"""Weights and checkpoints: ``.npz`` snapshots shared with the JAX
package, the reference's ``.pth`` import and training checkpoints."""
