"""Deterministic synthetic data (numpy, seeded)."""
