"""SLO-driven control plane: telemetry -> drift/SLO -> rebalance/scale.

The closed loop the paper's "fewer GPUs under SLO" result needs:
sliding-window telemetry over the live request stream, online drift
detection on per-adapter demand (Fig 10 shapes), SLO attainment
tracking, and a controller that rebalances on drift, provisions servers
under sustained violation, and drains them back under sustained
headroom — on both execution substrates.

A copy of the JAX package's ``controlplane/``; in the port it runs on the
real-engine substrate (``serving.backend.EngineBackend``).
"""
from .controller import (ACT_DRAIN, ACT_REBALANCE, ACT_RETIRE,
                         ACT_SCALE_UP, Action, ClusterController,
                         ClusterState, ControllerConfig)
from .drift import (DriftDetector, DriftEvent, KIND_DIURNAL, KIND_FALLING,
                    KIND_RISING, KIND_SURGE)
from .slo import SLOSpec, SLOTracker
from .telemetry import SlidingWindow, TelemetryHub

__all__ = ["Action", "ClusterController", "ClusterState",
           "ControllerConfig", "ACT_REBALANCE", "ACT_SCALE_UP",
           "ACT_DRAIN", "ACT_RETIRE",
           "DriftDetector", "DriftEvent", "KIND_RISING", "KIND_FALLING",
           "KIND_SURGE", "KIND_DIURNAL",
           "SLOSpec", "SLOTracker", "SlidingWindow", "TelemetryHub"]
