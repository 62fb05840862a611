"""Kernel entry points (``ops``), their plain PyTorch versions and the
hand-written CUDA sources under ``csrc/``."""
