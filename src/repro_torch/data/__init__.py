"""Workload generators of the PyTorch port (pure numpy)."""
