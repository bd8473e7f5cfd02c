"""Runnable examples of the PyTorch port (``python -m
repro_torch.examples.<name>``), counterparts of the JAX package's
``examples/``."""
