"""Circuits, surrogate artifact, Algorithm-1 wrapper and network engine
of the PyTorch port."""
