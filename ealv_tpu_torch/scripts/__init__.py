"""Entry points of the PyTorch port (``python -m ealv_tpu_torch.scripts.<name>``)."""
