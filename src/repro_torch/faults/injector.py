"""Fault injector: applies a ``FaultPlan``'s due events to a host.

The host is anything exposing ``apply_fault(event, now) -> bool`` —
``LoRAServeCluster`` (engine facade, wall or virtual clock),
``ClusterSimulator`` (virtual clock), and ``ServeGateway`` (asyncio
loop, for ``disconnect_client``). The injector owns the schedule
cursor and the applied/skipped log; the host owns the semantics.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from .plan import FaultEvent, FaultPlan


class FaultInjector:
    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.applied: List[Tuple[float, FaultEvent]] = []
        self.skipped: List[Tuple[float, FaultEvent]] = []

    def poll(self, now: float, host) -> List[FaultEvent]:
        """Fire every due event against ``host``. Events the host
        reports as inapplicable (e.g. stalling when nothing is in
        flight, crashing an already-dead server) are logged as skipped,
        not errors — chaos schedules are written blind to state."""
        fired: List[FaultEvent] = []
        for ev in self.plan.due(now):
            if host.apply_fault(ev, now):
                self.applied.append((now, ev))
                fired.append(ev)
            else:
                self.skipped.append((now, ev))
        return fired

    def next_time(self) -> Optional[float]:
        return self.plan.next_time()

    def done(self) -> bool:
        return self.plan.remaining() == 0
