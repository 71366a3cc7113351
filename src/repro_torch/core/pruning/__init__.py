"""Hybrid pruning: cavity patterns (C2 fine) and the prune plan (C1/C2)."""
