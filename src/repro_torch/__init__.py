"""PyTorch + CUDA port of the LASANA reproduction (see README)."""
