"""The benchmark of the PyTorch and CUDA port (``ealv_tpu_torch``) on one
H100: ``python3 -m port_bench.run --help``."""
