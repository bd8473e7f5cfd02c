"""Serving layer of the PyTorch port: the single-server engine and its
trace replay (``replay``), the unified page pool, the real-engine and
simulated backends, and the ``LoRAServeCluster`` facade over them."""
from repro_torch.core.request import Phase, Request, ServeRequest

from .backend import EngineBackend, ServingBackend, SimBackend
from .cluster import (ClusterEvent, ClusterReport, LoRAServeCluster,
                      ServeResult)
from .engine import ServingEngine
from .metrics import MetricsCollector, percentile
from .paging import OutOfPages, UnifiedPagePool
from .scheduler import replay

__all__ = ["Phase", "Request", "ServeRequest", "ServingEngine",
           "EngineBackend", "ServingBackend", "SimBackend", "ClusterEvent",
           "ClusterReport", "LoRAServeCluster", "ServeResult",
           "MetricsCollector", "percentile", "replay", "OutOfPages",
           "UnifiedPagePool"]
