"""PyTorch/CUDA port of ``ealv_tpu`` for one NVIDIA H100.

Mirrors the JAX package's layout (utils, ops, models, data, control, sim,
runtime); the JAX package is the reference it is tested against. Importing
this package imports torch and numpy only.

Device rule: every constructor and entry point that takes a ``device``
defaults to ``"cuda"``. A caller that wants the CPU passes
``device="cpu"``; nothing falls back to the CPU when CUDA is missing, so on
a machine without a card the default raises where torch first makes a CUDA
tensor.
"""
