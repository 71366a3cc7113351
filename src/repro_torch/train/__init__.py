"""Step-function factories: training and inference steps."""
