"""The plain reference: a frozen copy of the port's default tick in plain
torch. It imports nothing of the program (``ealv_tpu_torch``), of JAX or of
the JAX package."""
