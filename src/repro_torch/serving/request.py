"""Serving request lifecycle objects.

A copy of the JAX package's ``serving/request.py``: the lifecycle type
lives in :mod:`repro_torch.core.request`, shared by the simulator and the
real engine; this module re-exports it under the names the serving code
(``scheduler.py``) imports.
"""
from repro_torch.core.request import Phase, Request, ServeRequest  # noqa: F401

__all__ = ["Phase", "Request", "ServeRequest"]
