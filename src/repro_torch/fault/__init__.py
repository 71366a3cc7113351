"""Fault-tolerance monitors for the training loop."""
