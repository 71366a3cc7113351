"""Step-function factories."""
