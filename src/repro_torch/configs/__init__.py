"""Experiment configurations (only the paper's matmul sizes so far)."""
