"""Serving layer of the PyTorch port: the single-server engine."""
from repro_torch.core.request import Phase, Request, ServeRequest

from .engine import ServingEngine
from .metrics import MetricsCollector, percentile

__all__ = ["Phase", "Request", "ServeRequest", "ServingEngine",
           "MetricsCollector", "percentile"]
