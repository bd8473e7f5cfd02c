"""Serving layer of the PyTorch port: the single-server engine, the
real-engine backend, and the ``LoRAServeCluster`` facade over it."""
from repro_torch.core.request import Phase, Request, ServeRequest

from .backend import EngineBackend, ServingBackend
from .cluster import (ClusterEvent, ClusterReport, LoRAServeCluster,
                      ServeResult)
from .engine import ServingEngine
from .metrics import MetricsCollector, percentile

__all__ = ["Phase", "Request", "ServeRequest", "ServingEngine",
           "EngineBackend", "ServingBackend", "ClusterEvent",
           "ClusterReport", "LoRAServeCluster", "ServeResult",
           "MetricsCollector", "percentile"]
