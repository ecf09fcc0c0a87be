"""PyTorch/CUDA port of ``ealv_tpu`` for one NVIDIA H100.

Mirrors the JAX package's layout (utils, ops, models, data, control, sim,
runtime); the JAX package is the reference it is tested against. Importing
this package imports torch and numpy only.
"""
