"""Chaos plane: fault injection, failure detection, loss-free recovery.

Spans both substrates — the discrete-event ``ClusterSimulator`` and the
real-engine ``LoRAServeCluster`` facade consume the same seeded
``FaultPlan`` via a ``FaultInjector``, detect crashes with the same
heartbeat ``FailureDetector``, and re-dispatch in-flight work with the
same exactly-once continuation helpers.

A copy of the JAX package's ``faults/``; in the port the facade over
``serving.backend.EngineBackend`` consumes it.
"""
from .detector import FailureDetector
from .injector import FaultInjector
from .plan import (KIND_CRASH, KIND_DISCONNECT, KIND_LINK_DEGRADE,
                   KIND_LINK_DOWN, KIND_LINK_UP, KIND_RESTORE,
                   KIND_STALL_FETCH, KINDS, FaultEvent, FaultPlan)
from .recovery import (RecoveryRecord, delivered_tokens,
                       make_continuation, merge_continuation,
                       remaining_tokens)

__all__ = [
    "FaultEvent", "FaultPlan", "FaultInjector", "FailureDetector",
    "RecoveryRecord", "delivered_tokens", "make_continuation",
    "merge_continuation", "remaining_tokens", "KINDS", "KIND_CRASH",
    "KIND_RESTORE", "KIND_LINK_DOWN", "KIND_LINK_UP",
    "KIND_LINK_DEGRADE", "KIND_STALL_FETCH", "KIND_DISCONNECT",
]
