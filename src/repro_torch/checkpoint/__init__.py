"""Checkpoints of parameter and optimizer trees, in the JAX layout."""
