"""Kernel layer: CUDA sources (`csrc`), their build step, plain versions,
ops."""
