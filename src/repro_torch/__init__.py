"""PyTorch/CUDA port of the heterogeneous-LoRA serving system, beside the
JAX package ``repro`` (the reference). It imports ``torch``, never
``jax``, and nothing of ``repro``: it keeps its own copies of what it
needs. Entry points run on the card (``device="cuda"``) unless the caller
asks for the CPU."""
