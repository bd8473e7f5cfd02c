"""Request types of the PyTorch port (copies of the JAX package's)."""
from .request import Phase, Request, ServeRequest

__all__ = ["Phase", "Request", "ServeRequest"]
