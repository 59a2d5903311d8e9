"""Compute ops: integer-exact image filters (plain PyTorch + CUDA kernels)."""
