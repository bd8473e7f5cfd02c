"""The closed control loop: telemetry -> drift/SLO -> action.

``ClusterController`` is substrate-neutral: the host (the
discrete-event ``ClusterSimulator`` or the ``LoRAServeCluster`` facade
over real engines) feeds it request lifecycle events, calls ``tick``
with a ``ClusterState`` snapshot on its own clock, and executes the
returned ``Action``s through the existing orchestrator / adapter-store
machinery. The policy, in priority order:

1. **retire** any draining server the host reports empty (no HBM
   copies, no queued/running work, no in-flight transfers touching it);
2. on **drift** (new ``DriftEvent``s this tick) or an **SLO
   violation**, trigger an out-of-band rebalance so placement chases
   the new demand shape instead of waiting for the periodic timestep;
3. on **sustained violation** (``patience`` consecutive bad ticks) with
   room under ``max_servers``, **scale up** one server;
4. on **sustained headroom** (``drain_patience`` consecutive ticks at
   target attainment with windowed P95 TTFT under ``drain_margin *
   slo.ttft`` and per-server load light), **drain** the least-loaded
   server — the paper's fewer-GPUs-under-SLO claim closed end to end.

Scale actions share a cooldown so the loop cannot flap; draining pauses
all scaling until the drain retires.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from .drift import DriftDetector, DriftEvent
from .slo import SLOSpec, SLOTracker
from .telemetry import TelemetryHub

ACT_REBALANCE = "rebalance"
ACT_SCALE_UP = "scale-up"
ACT_DRAIN = "drain"
ACT_RETIRE = "retire"


@dataclasses.dataclass(frozen=True)
class Action:
    kind: str                 # rebalance | scale-up | drain | retire
    time: float
    server: int = -1          # target (drain/retire)
    reason: str = ""


@dataclasses.dataclass
class ClusterState:
    """Host-built snapshot the controller decides on."""
    now: float
    active: List[int]                       # serving (non-draining) ids
    draining: List[int] = dataclasses.field(default_factory=list)
    drained: List[int] = dataclasses.field(default_factory=list)
    # ^ draining servers now empty and safe to retire
    queue_depth: Dict[int, float] = dataclasses.field(default_factory=dict)
    # busy fraction over the last tick window, 0..1 per server; drains
    # are gated on the *projected* utilization after losing one server
    utilization: Dict[int, float] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class ControllerConfig:
    tick_period: float = 5.0
    min_servers: int = 1
    max_servers: int = 8
    patience: int = 2            # bad ticks before a scale-up
    drain_patience: int = 4      # comfortable ticks before a drain
    cooldown: float = 20.0       # seconds between scale actions
    rebalance_cooldown: float = 10.0
    drain_margin: float = 0.5    # windowed P95 TTFT must sit under
    #                              drain_margin * slo.ttft to drain
    drain_queue_depth: float = 2.0   # ...and mean queue depth under this
    drain_util: float = 0.7      # ...and projected post-drain mean busy
    #                              fraction (util * n/(n-1)) under this
    min_samples: int = 5
    drift_min_share: float = 0.02    # only watch adapters carrying at
    #                                  least this share of windowed
    #                                  traffic (tail rates are pure
    #                                  Poisson noise; the head is what
    #                                  placement can chase — Fig 8)


class ClusterController:
    def __init__(self, slo: SLOSpec,
                 config: Optional[ControllerConfig] = None,
                 detector: Optional[DriftDetector] = None,
                 operating_points: Optional[Dict[int, float]] = None,
                 adapter_ranks: Optional[Dict[str, int]] = None):
        self.config = config or ControllerConfig()
        self.spec = slo
        self.telemetry = TelemetryHub(window=slo.window)
        self.slo = SLOTracker(slo)
        self.detector = detector or DriftDetector()
        # Algorithm-1 capacity math for the drain gate: windowed demand
        # (tokens/s) over per-rank operating points = servers' worth of
        # demand. Optional — without it the host's busy-fraction
        # heuristic gates drains instead.
        self.operating_points = operating_points
        self.adapter_ranks = adapter_ranks or {}
        self.actions: List[Action] = []       # everything ever emitted
        # decision inputs of the most recent tick — the flight
        # recorder's audit record for scale/drain/SLO-violation dumps
        self.last_inputs: dict = {}
        self.server_failures: List = []   # (server, now) crash log
        self._bad_ticks = 0
        self._good_ticks = 0
        self._last_scale = -float("inf")
        self._last_rebalance = -float("inf")
        self.ticks = 0

    # -- host feeds (both substrates call these) --------------------------
    def observe_arrival(self, adapter_id: str, server: int,
                        tokens: float, now: float) -> None:
        self.telemetry.observe_arrival(adapter_id, server, tokens, now)

    def observe_completion(self, req, now: float) -> None:
        self.telemetry.observe_completion(req, now)
        self.slo.observe(req, now)

    def observe_timeout(self, now: float) -> None:
        self.telemetry.observe_timeout(now)
        self.slo.observe_timeout(now)

    def observe_failure(self, server: int, now: float) -> None:
        """Chaos plane: a server was confirmed dead and recovered
        around. Capacity just dropped out from under the SLO window, so
        the scale-down comfort streak resets — the controller must not
        drain a survivor on pre-crash telemetry."""
        self.server_failures.append((server, now))
        self._good_ticks = 0

    # -- introspection ----------------------------------------------------
    def drift_events(self) -> List[DriftEvent]:
        return list(self.detector.events)

    def count(self, kind: str) -> int:
        return sum(1 for a in self.actions if a.kind == kind)

    # -- the loop ---------------------------------------------------------
    def tick(self, state: ClusterState) -> List[Action]:
        cfg = self.config
        now = state.now
        self.ticks += 1
        out: List[Action] = []

        # 1. finish drains first: an empty draining server retires now
        for sid in state.drained:
            out.append(self._act(ACT_RETIRE, now, server=sid,
                                 reason="drain complete"))

        # sample per-adapter demand once per tick for the detector,
        # head adapters only (tail windowed rates are Poisson noise)
        rates = self.telemetry.adapter_rates(now)
        total_rate = sum(rates.values())
        floor = cfg.drift_min_share * total_rate
        new_drift = self.detector.observe(
            {aid: r for aid, r in rates.items() if r >= floor}, now)

        n_active = len(state.active)
        violated = self.slo.violated(now, cfg.min_samples)
        self.last_inputs = {
            "now": now,
            "n_active": n_active,
            "attainment": self.slo.attainment(now),
            "window_samples": self.slo.sample_count(now),
            "violated": violated,
            "bad_ticks": self._bad_ticks + (1 if violated else 0),
            "good_ticks": self._good_ticks,
            "windowed_p95_ttft": self.telemetry.ttft_percentile(95, now),
            "demand_servers": self.demand_servers(now),
            "drift_events": [dataclasses.asdict(e) for e in new_drift],
            "server_failures": len(self.server_failures),
        }
        if violated:
            self._bad_ticks += 1
            self._good_ticks = 0
        else:
            self._bad_ticks = 0
            if self._comfortable(state):
                self._good_ticks += 1
            else:
                self._good_ticks = 0

        # 2. drift or violation: chase the new shape with a rebalance
        if (new_drift or violated) and \
                now - self._last_rebalance >= cfg.rebalance_cooldown:
            why = (f"drift:{','.join(e.kind for e in new_drift)}"
                   if new_drift else
                   f"slo attainment "
                   f"{self.slo.attainment(now):.2f}<{self.spec.target}")
            out.append(self._act(ACT_REBALANCE, now, reason=why))
            self._last_rebalance = now

        draining = bool(state.draining)
        cool = now - self._last_scale < cfg.cooldown

        # 3. sustained violation: add a server
        if self._bad_ticks >= cfg.patience and not draining and \
                not cool and n_active < cfg.max_servers:
            out.append(self._act(
                ACT_SCALE_UP, now,
                reason=f"attainment {self.slo.attainment(now):.2f} "
                       f"for {self._bad_ticks} ticks"))
            self._last_scale = now
            self._bad_ticks = 0

        # 4. sustained headroom: give a server back (the least-loaded
        # one by windowed token rate; its traffic re-places elsewhere)
        elif self._good_ticks >= cfg.drain_patience and not draining \
                and not cool and n_active > cfg.min_servers:
            victim = min(state.active,
                         key=lambda s: (
                             self.telemetry.server_token_rate(s, now),
                             state.queue_depth.get(s, 0.0), s))
            out.append(self._act(
                ACT_DRAIN, now, server=victim,
                reason=f"headroom for {self._good_ticks} ticks"))
            self._last_scale = now
            self._good_ticks = 0

        return out

    def demand_servers(self, now: float) -> Optional[float]:
        """Servers' worth of windowed demand (Algorithm 1 Step 1):
        sum over adapters of token_rate / operating_point(rank). None
        when the controller has no operating points."""
        if not self.operating_points:
            return None
        total = 0.0
        for aid, rate in self.telemetry.adapter_rates(now).items():
            rank = self.adapter_ranks.get(aid)
            op = self.operating_points.get(rank)
            if op:
                total += rate / op
        return total

    def _comfortable(self, state: ClusterState) -> bool:
        """Headroom check gating drains: attainment at target on real
        evidence, windowed P95 TTFT well under the target, queues
        shallow, and projected capacity after losing one server still
        inside ``drain_util``."""
        cfg = self.config
        now = state.now
        if not self.slo.headroom(now, cfg.min_samples):
            return False
        p95 = self.telemetry.ttft_percentile(95, now)
        if p95 is None or p95 > cfg.drain_margin * self.spec.ttft:
            return False
        if state.active:
            mean_q = sum(state.queue_depth.get(s, 0.0)
                         for s in state.active) / len(state.active)
            if mean_q > cfg.drain_queue_depth:
                return False
        n = len(state.active)
        if n <= 1:
            return False
        want = self.demand_servers(now)
        if want is not None:
            # paper-native capacity gate: demand in server-equivalents
            # against the fleet one server smaller
            if want / (n - 1) > cfg.drain_util:
                return False
        elif state.utilization:
            # fallback: host-reported busy fraction
            mean_u = sum(state.utilization.get(s, 0.0)
                         for s in state.active) / n
            if mean_u * n / (n - 1) > cfg.drain_util:
                return False
        return True

    def _act(self, kind: str, now: float, server: int = -1,
             reason: str = "") -> Action:
        a = Action(kind=kind, time=now, server=server, reason=reason)
        self.actions.append(a)
        return a
