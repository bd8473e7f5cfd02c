"""Core of the PyTorch port: request types, and copies of the JAX
package's control plane — rank- and demand-aware placement (Algorithm 1),
phi-weighted routing, the tiered adapter store, demand estimation and the
orchestrator. The copies import nothing of ``repro``; none of them touches
the device."""
from .baselines import (POLICIES, ContiguousPolicy, LoraservePolicy,
                        RandomPolicy, ToppingsPolicy)
from .demand import DemandEstimator
from .orchestrator import ClusterOrchestrator
from .placement import assign_loraserve
from .pool import AdapterStore, DistributedAdapterPool, FetchPlan
from .request import Phase, Request, ServeRequest
from .routing import RetiredServerError, RoutingTable, UnknownAdapterError
from .types import (AdapterInfo, Placement, PlacementContext,
                    PlacementStats, servers_to_adapters)

__all__ = ["ContiguousPolicy", "LoraservePolicy", "POLICIES", "RandomPolicy",
           "ToppingsPolicy", "DemandEstimator", "ClusterOrchestrator",
           "assign_loraserve", "AdapterStore", "DistributedAdapterPool",
           "FetchPlan", "Phase", "Request", "ServeRequest",
           "RetiredServerError", "RoutingTable", "UnknownAdapterError",
           "AdapterInfo", "Placement", "PlacementContext", "PlacementStats",
           "servers_to_adapters"]
