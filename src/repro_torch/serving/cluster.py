"""LoRAServeCluster: one serving facade over either execution substrate.

Owns the paper's control plane (``ClusterOrchestrator``: placement
policy, phi-weighted routing table, tiered adapter store, demand
estimator) and drives a ``ServingBackend`` (simulated or real-JAX) on a
shared clock:

* arrivals are phi-routed (Fig 11 steps 1-2) and the adapter's data
  path comes back as a ``FetchPlan`` from the tiered ``AdapterStore``
  (steps 3-4): a hit, an asynchronous migrate fetch the request waits
  out, or — with ``access_mode="remote-read"`` — an immediate serve
  reading weights from a peer's copy over GDR while the local copy
  warms in the background;
* every ``rebalance_period`` seconds the demand window closes and
  ``end_of_timestep`` re-places adapters (steps 6-7) *while requests are
  in flight*: the routing table and store are re-seeded mid-run, idle
  adapters are evicted from server banks, subsequent requests follow
  the updated phi, and with ``prefetch=True`` newly-placed copies start
  warming immediately instead of migrating lazily on first hit;
* the loop polls the store each tick so fetch completions install
  copies, promote remote-read serves, and push prefetched adapters into
  backend banks;
* completions stream back as ``ServeResult`` records through one
  ``MetricsCollector`` regardless of backend.

The cluster API is **incremental**: requests arrive one at a time via
``submit(request)``, the loop body is ``poll(now)`` (store completions,
due rebalances/controller ticks, one backend step, completion/timeout/
token events out), and ``drain()`` finishes whatever is in flight.
``run(trace)`` — the batch replay every benchmark uses — is implemented
on top of exactly those three calls, so a live gateway
(``repro.server``) and a trace replay exercise the same control plane.

Adapters have a runtime lifecycle too: ``register_adapter`` makes a new
adapter servable mid-run (placed on the emptiest server, folded into
subsequent rebalances), and ``unregister_adapter`` starts a loss-free
retire — routing stops immediately, in-flight requests finish, then the
copies leave the banks and the store.

This is the unified serving API the launcher, gateway, examples, and
benchmarks build on.

PyTorch port: a copy of the JAX package's ``serving/cluster.py`` over the
port's own copies of ``core/``, ``cluster/``, ``controlplane/`` and
``faults/``. One difference: the span layer (``obs/``) is not ported, so
``tracer`` and ``flight_recorder`` stay in the signature and raise when
given.
"""
from __future__ import annotations

import copy
import dataclasses
import math
import time
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.core import ClusterOrchestrator
from repro_torch.core.request import ServeRequest
from repro_torch.core.routing import UnknownAdapterError
from repro_torch.core.types import AdapterInfo, Placement, servers_to_adapters

from .backend import ServingBackend
from .metrics import MetricsCollector, percentile


@dataclasses.dataclass(frozen=True)
class ServeResult:
    """Per-request outcome, identical for sim and real backends."""
    req_id: int
    adapter_id: str
    rank: int
    server: int
    arrival: float
    finished: bool
    ttft: Optional[float]
    tbt: Optional[float]
    fetch_latency: float
    n_output: int


@dataclasses.dataclass(frozen=True)
class ClusterEvent:
    """One observable outcome of a ``poll`` tick.

    ``kind`` is ``"token"`` (``tokens`` holds the newly decoded token
    ids; ``None`` entries for the simulated substrate, which models
    token *counts*, not values), ``"finish"`` (request completed;
    ``tokens`` carries any tokens not yet surfaced), or ``"timeout"``.
    """
    kind: str
    req: ServeRequest
    tokens: Tuple = ()
    now: float = 0.0


@dataclasses.dataclass
class ClusterReport:
    results: List[ServeResult]
    summary: dict
    rebalances: int                    # control-loop timesteps fired
    placements: List[Placement]        # history; >1 entry => re-placed
    per_server_counts: List[int]
    timed_out: int
    fetches: int
    fetch_bytes: int
    max_adapters_per_server: int
    total_adapter_bytes: int
    memory_profile: List[dict]
    warmup: float = 0.0
    bank_mode: str = "padded"          # bank layout the backend ran with
    mesh_shape: Optional[tuple] = None  # (dp, tp) engine mesh, if sharded
    in_progress: int = 0               # unfinished at snapshot time
    # adapter data-plane telemetry
    access_mode: str = "migrate"       # migrate | remote-read
    remote_reads: int = 0              # misses served via peer GDR reads
    prefetches: int = 0                # rebalance-driven proactive warms
    coalesced_fetches: int = 0         # duplicate fetches joined in flight
    # adapter lifecycle (runtime register/unregister)
    registered: int = 0
    unregistered: int = 0
    # control-plane telemetry (controller runs only)
    scale_ups: int = 0
    drains: int = 0
    retires: int = 0
    controller_rebalances: int = 0     # out-of-band (drift/SLO) ones
    gpu_seconds: float = 0.0           # per-server provision->retire
    final_servers: int = 0             # active fleet size at end of run
    drift_events: List = dataclasses.field(default_factory=list)
    controller_actions: List = dataclasses.field(default_factory=list)
    # observability (tracer-attached runs only)
    cost_drift: dict = dataclasses.field(default_factory=dict)
    trace_spans: int = 0
    flight_dumps: int = 0
    # chaos plane (repro.faults)
    server_failures: int = 0           # injected crashes
    recoveries: int = 0                # detected + recovered crashes
    redispatched: int = 0              # continuation requests issued
    cancelled: int = 0                 # client-cancelled requests
    fetch_retries: int = 0             # transfer attempts relaunched
    fetch_timeouts: int = 0            # attempts that blew their deadline
    breaker_opens: int = 0             # circuit-breaker open transitions
    recovery_records: List = dataclasses.field(default_factory=list)

    def _eligible(self) -> List[ServeResult]:
        return [r for r in self.results
                if r.finished and r.arrival >= self.warmup]

    def _ttfts(self) -> List[float]:
        return [r.ttft for r in self._eligible() if r.ttft is not None]

    # percentile helpers are snapshot-safe: an empty or still-warming
    # window returns NaN (not inf, not an exception) so a mid-flight
    # /metrics scrape renders cleanly
    def p50_ttft(self) -> float:
        t = self._ttfts()
        return percentile(t, 50) if t else float("nan")

    def p95_ttft(self) -> float:
        t = self._ttfts()
        return percentile(t, 95) if t else float("nan")

    def mean_tbt(self) -> float:
        ts = [r.tbt for r in self._eligible() if r.tbt and r.tbt > 0]
        return sum(ts) / len(ts) if ts else 0.0

    def p95_tbt(self) -> float:
        ts = [r.tbt for r in self._eligible() if r.tbt and r.tbt > 0]
        return percentile(ts, 95) if ts else 0.0

    def completed(self) -> int:
        return sum(1 for r in self.results if r.finished)

    def placement_changed(self) -> bool:
        return len(self.placements) > 1

    def meets_slo(self, slo_ttft: float) -> bool:
        p95 = self.p95_ttft()
        return self.timed_out == 0 and not math.isnan(p95) \
            and p95 <= slo_ttft

    def slo_attainment(self, slo_ttft: float) -> float:
        """Fraction of eligible requests with TTFT inside the target;
        unfinished/dropped requests count as misses."""
        elig = [r for r in self.results if r.arrival >= self.warmup]
        if not elig:
            return 1.0
        ok = sum(1 for r in elig
                 if r.finished and r.ttft is not None
                 and r.ttft <= slo_ttft)
        return ok / len(elig)


class LoRAServeCluster:
    """Incremental cluster serving: ``submit`` / ``poll`` / ``drain``,
    with the one-shot batch ``run(trace)`` implemented on top."""

    def __init__(self, backend: ServingBackend,
                 adapters: List[AdapterInfo], *,
                 policy: str = "loraserve", network=None,
                 rebalance_period: float = 15.0, warmup: float = 0.0,
                 seed: int = 0, operating_points=None, server_model=None,
                 access_mode: str = "migrate", prefetch: bool = False,
                 controller=None, track_tokens: bool = False,
                 telemetry_window: float = 30.0,
                 tracer=None, flight_recorder=None,
                 fault_plan=None, detector_window: float = 0.5,
                 durable_ssd: bool = False, retry_policy=None):
        if tracer is not None or flight_recorder is not None:
            raise NotImplementedError(
                "tracer/flight_recorder: the span layer (obs/) is not "
                "ported yet (ROADMAP A4)")
        if operating_points is None:
            from repro_torch.cluster.costmodel import (ServerModel,
                                                       profile_operating_points)
            server_model = server_model or ServerModel()
            operating_points = profile_operating_points(
                server_model, {a.rank for a in adapters})
        self.backend = backend
        self.adapters = adapters
        self.meta = {a.adapter_id: a for a in adapters}
        self.rebalance_period = rebalance_period
        self.warmup = warmup
        self.access_mode = access_mode
        self._server_model = server_model   # for runtime-registered ranks
        # closed-loop control plane (repro.controlplane): may rebalance
        # out of band, provision servers, and drain them mid-run
        self.controller = controller
        if controller is not None:
            # hand it the capacity model for Algorithm-1 drain gating
            if controller.operating_points is None:
                controller.operating_points = dict(operating_points)
            if not controller.adapter_ranks:
                controller.adapter_ranks = {a.adapter_id: a.rank
                                            for a in adapters}
        self.orch = ClusterOrchestrator(
            backend.n_servers, adapters, operating_points, policy=policy,
            network=network, seed=seed, access_mode=access_mode,
            prefetch=prefetch, sync_store=False, retry=retry_policy,
            durable_ssd=durable_ssd)
        self.metrics = MetricsCollector()
        # always-on live telemetry window (the gateway's /metrics feed);
        # lazy import keeps repro.serving importable without dragging
        # the whole control plane in at module-import time
        from repro_torch.controlplane.telemetry import TelemetryHub
        self.hub = TelemetryHub(window=telemetry_window)
        self.placements: List[Placement] = [
            copy.deepcopy(self.orch.placement)]
        self.rebalances = 0
        self.controller_rebalances = 0
        self.scale_ups = 0
        self.drains = 0
        self.retires = 0
        self.registered = 0              # runtime adapter registrations
        self.unregistered = 0            # completed retires
        self._provisioned_at: Dict[int, float] = {
            i: 0.0 for i in range(backend.n_servers)}
        self._retired_at: Dict[int, float] = {}
        self.per_server_counts = [0] * backend.n_servers
        self.routed: Dict[int, int] = {}       # req_id -> server
        self._submitted: List[ServeRequest] = []
        self._finished: List[ServeRequest] = []
        self._timed_out: List[ServeRequest] = []
        self._retiring: Set[str] = set()       # adapters mid-unregister
        # per-token streaming: watermark of surfaced tokens per request
        self.track_tokens = track_tokens
        self._stream_pos: Dict[int, int] = {}
        # chaos plane (repro.faults): optional scripted injector, an
        # always-armed heartbeat detector (beat-then-check per poll, so
        # false positives are structurally impossible), and
        # exactly-once continuation bookkeeping for re-dispatch
        from repro_torch.faults import FailureDetector, FaultInjector
        self.injector = (FaultInjector(fault_plan)
                         if fault_plan is not None else None)
        self.detector = FailureDetector(window=detector_window)
        self._crashed: Set[int] = set()        # crashed, not yet recovered
        self._recovered: Set[int] = set()      # recovery ran (still down)
        self._failed_at: Dict[int, float] = {}
        self._cont_orig: Dict[int, ServeRequest] = {}   # req_id -> orig
        self._stream_base: Dict[int, int] = {}  # continuation offset
        self._pending_events: List[ClusterEvent] = []   # recovery-emitted
        self.pending_disconnects: List[int] = []   # gateway fault queue
        self.server_failures = 0
        self.recoveries = 0
        self.redispatched = 0
        self.cancelled = 0
        self.recovery_records: List = []
        self._ran = False
        self._started = False
        self._closed = False
        self._now = 0.0
        self._last_reb = 0.0
        self._next_reb = float("inf")
        self._next_ctick = float("inf")
        self._end_time = 0.0
        # -- observability wiring (before _seed_backend so lazily built
        # engines inherit the tracer) --------------------------------------
        self.tracer = tracer
        self.flight_recorder = flight_recorder
        self.cost_drift = None
        self._slo_bad = False
        self._tracer_adv = None
        self._record_spans = None
        self._seed_backend()
        # running peaks across rebalances (the store GCs lazily, so the
        # end-of-run state understates what a server actually held)
        self._max_adapters = self.orch.store.max_adapters_per_server()
        self._total_bytes = self.orch.store.total_bytes()

    # -- placement -> backend sync --------------------------------------
    def _seed_backend(self) -> None:
        for sid, aids in servers_to_adapters(self.orch.placement).items():
            self.backend.load_adapters(
                sid, {aid: self.meta[aid].rank for aid in aids})

    # -- incremental lifecycle -------------------------------------------
    def start(self) -> None:
        """Anchor the clocks and arm the periodic control loops. Called
        implicitly by the first ``submit``/``poll``/``run``."""
        if self._started:
            return
        self._started = True
        self.backend.start()
        self._wall0 = time.monotonic()
        self._now = 0.0
        self._last_reb = 0.0
        self._next_reb = (self.rebalance_period
                          if self.orch.policy.dynamic else float("inf"))
        self._next_ctick = (self.controller.config.tick_period
                            if self.controller is not None
                            else float("inf"))

    def clock(self) -> float:
        """Current time on the cluster clock: the backend's wall clock
        when it has one, otherwise wall seconds since ``start()`` (a
        virtual backend driven live advances in real time)."""
        if not self._started:
            return 0.0
        if self.backend.realtime:
            return self.backend.wall_now()
        return time.monotonic() - self._wall0

    def pending(self) -> int:
        return self.backend.pending()

    def idle(self) -> bool:
        """No requests in flight, no drains or adapter retires pending."""
        return (self.backend.pending() == 0 and not self.orch.draining
                and not self._retiring)

    # -- request path (Fig 11 steps 1-4) --------------------------------
    def submit(self, req: ServeRequest,
               now: Optional[float] = None) -> int:
        """Admit one request: phi-route it, plan its adapter's data
        path, and hand it to the backend. Returns the chosen server.
        Raises ``UnknownAdapterError`` for unregistered (or retiring)
        adapters."""
        self.start()
        if now is None:
            now = self.clock()
        self._dispatch(req, now)
        self._submitted.append(req)
        return self.routed[req.req_id]

    def _dispatch(self, req: ServeRequest, now: float) -> None:
        aid = req.adapter_id
        if req.rank == 0 and aid in self.meta:
            req.rank = self.meta[aid].rank
        if aid in self._retiring:
            raise UnknownAdapterError(aid)
        if self.orch.policy.replicate_all:
            if aid not in self.meta:
                raise UnknownAdapterError(aid)
            sid = min(self.orch.placeable_servers(),
                      key=lambda i: self.backend.server_load(i, now))
            req.fetch_latency = 0.0
            self.backend.load_adapters(sid, {aid: req.rank})
        else:
            sid, plan = self.orch.route_plan(
                aid, tokens=req.prompt_len + req.output_len, now=now)
            req.apply_fetch_plan(plan, now)
            if plan.hit or plan.blocking:
                self.backend.load_adapters(sid, {aid: req.rank})
            else:
                # serve immediately from the peer copy; the warm fetch
                # promotes it at plan.eta
                self.backend.load_adapter_remote(sid, aid, req.rank,
                                                 plan.read_peer)
        if self.tracer is not None:
            # zero-width instant: the routing decision itself
            self.tracer.record("route", now, now, cat="gateway",
                               track="control", req_id=req.req_id,
                               attrs={"server": sid, "adapter_id": aid})
        self.backend.submit(sid, req, now)
        self.per_server_counts[sid] += 1
        self.routed[req.req_id] = sid
        self.hub.observe_arrival(aid, sid,
                                 req.prompt_len + req.output_len, now)
        if self.controller is not None:
            self.controller.observe_arrival(
                aid, sid, req.prompt_len + req.output_len, now)

    def _poll_store(self, now: float) -> None:
        """Drain adapter-store fetch completions: install prefetched
        and drain-migrated copies in backend banks and promote
        remote-read serves. The promote is unconditional (a no-op
        discard for non-remote copies) because a remote-read serve may
        have coalesced onto a transfer that started as a prefetch or
        migrate fetch."""
        for plan in self.orch.store.poll(now):
            aid = plan.adapter_id
            if plan.mode in ("prefetch", "drain"):
                self.backend.load_adapters(
                    plan.dest, {aid: self.meta[aid].rank})
            self.backend.promote_adapter(plan.dest, aid)

    # -- chaos plane (repro.faults) ---------------------------------------
    def apply_fault(self, ev, now: float) -> bool:
        """``FaultInjector`` host hook: apply one due fault event.
        Returns False for events that don't apply to the current state
        (chaos schedules are written blind to it)."""
        from repro_torch.faults import (KIND_CRASH, KIND_DISCONNECT,
                                        KIND_LINK_DEGRADE, KIND_LINK_DOWN,
                                        KIND_LINK_UP, KIND_RESTORE,
                                        KIND_STALL_FETCH)
        net = self.orch.store.network
        if ev.kind == KIND_CRASH:
            return self.inject_crash(ev.target, now)
        if ev.kind == KIND_RESTORE:
            return self.inject_restore(ev.target, now)
        if ev.kind == KIND_LINK_DOWN:
            if net is None:
                return False
            net.set_link_down(ev.target)
            return True
        if ev.kind == KIND_LINK_UP:
            if net is None:
                return False
            net.set_link_up(ev.target)
            return True
        if ev.kind == KIND_LINK_DEGRADE:
            if net is None:
                return False
            net.degrade_link(ev.target, max(1.0, ev.arg))
            return True
        if ev.kind == KIND_STALL_FETCH:
            return self.inject_stall(ev.target, ev.arg)
        if ev.kind == KIND_DISCONNECT:
            # gateway-level fault: queue it for the SSE front end (the
            # pump drains these and severs the matching live stream)
            self.pending_disconnects.append(int(ev.target))
            return True
        return False

    def inject_crash(self, sid: int, now: Optional[float] = None) -> bool:
        """Fail-stop server ``sid``: execution freezes, heartbeats stop,
        and the detector confirms it dead one window later (recovery
        runs then). No-op for unknown/retired/already-dead servers."""
        if now is None:
            now = self._now
        if (sid < 0 or sid >= self.backend.n_servers
                or sid in self._retired_at or sid in self._crashed
                or sid in self._recovered):
            return False
        # final beat at the crash instant: the detector's silence window
        # starts now (covers crashes injected before the first poll)
        self.detector.beat(sid, now)
        self.backend.fail_server(sid)
        self._crashed.add(sid)
        self._failed_at[sid] = now
        self.server_failures += 1
        if self.flight_recorder is not None:
            self.flight_recorder.dump("fault-crash", now, {"server": sid})
        return True

    def inject_restore(self, sid: int,
                       now: Optional[float] = None) -> bool:
        """Bring a crashed server back. If recovery already ran it
        rejoins the fleet empty (placement re-warms it); if the crash
        was never detected (a sub-window flap) the stranded work simply
        resumes."""
        if now is None:
            now = self._now
        if sid not in self._crashed and sid not in self._recovered:
            return False
        self.backend.restore_server(sid)
        if sid in self._recovered:
            self._recovered.discard(sid)
            self.orch.restore_server(sid, now)
            self._sync_banks(self.orch.placement)
        self._crashed.discard(sid)
        self.detector.restore(sid, now)
        if self.flight_recorder is not None:
            self.flight_recorder.dump("fault-restore", now,
                                      {"server": sid})
        return True

    def inject_stall(self, target: int = -1,
                     extra: float = 0.0) -> bool:
        """Freeze (``extra == 0``) or slow one in-flight transfer
        touching server ``target`` (any transfer when -1)."""
        store = self.orch.store
        for (dest, aid), p in sorted(store._inflight.items()):
            if p.retry_at >= 0:
                continue
            if target >= 0 and dest != target and p.src_server != target:
                continue
            return store.stall_transfer(
                dest, aid, extra if extra > 0 else float("inf"))
        return False

    def _beat_and_check(self, now: float) -> None:
        """Heartbeat every alive server, then confirm the silent ones —
        beat-then-check inside one poll means a virtual-clock jump can
        never outrun a healthy server's beats."""
        for sid in range(self.backend.n_servers):
            if sid in self._retired_at:
                # scale-in, not a crash: silence is expected — stop
                # watching so the detector never falsely confirms it
                self.detector.remove(sid)
                continue
            if sid in self._recovered:
                continue
            if self.backend.server_alive(sid):
                self.detector.beat(sid, now)
        for sid in self.detector.check(now):
            if sid in self.orch.active:
                self._recover_server(sid, now)

    def _recover_server(self, sid: int, now: float) -> None:
        """Confirmed-dead recovery: collect the stranded requests, drop
        the server from placement/routing (orphaned adapters re-warm on
        survivors), and re-dispatch every stranded request from its
        last client-visible token."""
        from repro_torch.faults import RecoveryRecord
        detected = now
        stranded = self.backend.drain_failed(sid)
        plans = self.orch.fail_server(sid, now=now)
        self._crashed.discard(sid)
        self._recovered.add(sid)
        if self.controller is not None and \
                hasattr(self.controller, "observe_failure"):
            self.controller.observe_failure(sid, now)
        redone = 0
        for req in sorted(stranded, key=lambda r: r.req_id):
            if self._redispatch(req, now):
                redone += 1
        self.recoveries += 1
        rec = RecoveryRecord(server=sid, detected_at=detected,
                             recovered_at=now, redispatched=redone,
                             orphaned_adapters=len(plans))
        self.recovery_records.append(rec)
        if self.flight_recorder is not None:
            self.flight_recorder.dump(
                "fault-recover", now,
                {"server": sid, "redispatched": redone,
                 "stranded": len(stranded),
                 "recovery_plans": len(plans),
                 "crashed_at": self._failed_at.get(sid, now)})

    def _redispatch(self, req: ServeRequest, now: float) -> bool:
        """Exactly-once re-dispatch of one stranded request: surface
        any host-side tokens the client has not seen yet, then submit a
        continuation for the remaining budget under the same
        ``req_id``. Requests that already had every token are finalized
        directly."""
        from repro_torch.faults import (delivered_tokens, make_continuation,
                                        remaining_tokens)
        if req.req_id in self._cont_orig:
            # a continuation itself stranded: re-continue the original
            orig = self._cont_orig.pop(req.req_id)
            from repro_torch.faults import merge_continuation
            merge_continuation(orig, req)
            self._stream_base.pop(req.req_id, None)
            req = orig
            req.finish = -1.0
            req.t_finish = None
        if self.track_tokens:
            toks = self._new_tokens(req)
        else:
            self._stream_pos[req.req_id] = delivered_tokens(req)
            toks = ()
        if toks:
            self._pending_events.append(
                ClusterEvent("token", req, toks, now))
        if remaining_tokens(req) <= 0:
            # every token was generated; only the completion was lost
            from repro_torch.core.request import Phase
            req.finish = now
            req.t_finish = now
            req.phase = Phase.DONE
            self.metrics.record(req)
            self.hub.observe_completion(req, now)
            self._finished.append(req)
            self._stream_pos.pop(req.req_id, None)
            self._stream_base.pop(req.req_id, None)
            self._pending_events.append(
                ClusterEvent("finish", req, (), now))
            return False
        cont = make_continuation(req, now)
        self._cont_orig[req.req_id] = req
        self._stream_base[req.req_id] = delivered_tokens(req)
        try:
            self._dispatch(cont, now)
        except UnknownAdapterError:
            # adapter retired mid-crash: surface a timeout, not silence
            self._cont_orig.pop(req.req_id, None)
            self._stream_base.pop(req.req_id, None)
            self._timed_out.append(req)
            self.hub.observe_timeout(now)
            self._stream_pos.pop(req.req_id, None)
            self._pending_events.append(
                ClusterEvent("timeout", req, (), now))
            return False
        self.redispatched += 1
        return True

    def take_disconnects(self) -> List[int]:
        """Drain queued ``disconnect_client`` fault targets (consumed
        by the gateway's pump, which severs the matching stream)."""
        out, self.pending_disconnects = self.pending_disconnects, []
        return out

    def cancel_request(self, req_id: int) -> bool:
        """Abort a live request (client went away): free its backend
        slot/queue entry and drop its streaming state. Returns True if
        the request was live."""
        req = self.backend.cancel_request(req_id)
        if req is None:
            return False
        self.cancelled += 1
        self._stream_pos.pop(req_id, None)
        self._stream_base.pop(req_id, None)
        self._cont_orig.pop(req_id, None)
        return True

    # -- runtime adapter lifecycle ----------------------------------------
    def register_adapter(self, info: AdapterInfo,
                         now: Optional[float] = None) -> int:
        """Make a new adapter servable mid-run: place it on the
        emptiest live server, seed the store/routing entries, and load
        it into that server's bank. Subsequent rebalances fold it into
        the demand-driven placement. Returns the initial server id."""
        if now is None:
            now = self._now
        if info.adapter_id in self.meta:
            raise ValueError(f"adapter {info.adapter_id!r} is already "
                             f"registered")
        if info.rank not in self.orch.operating_points:
            from repro_torch.cluster.costmodel import (ServerModel,
                                                       profile_operating_points)
            pts = profile_operating_points(
                self._server_model or ServerModel(), {info.rank})
            self.orch.operating_points.update(pts)
            if self.controller is not None \
                    and self.controller.operating_points is not None:
                self.controller.operating_points.update(pts)
        sid = self.orch.register_adapter(info, now=now)
        self.meta[info.adapter_id] = info
        self.backend.load_adapters(sid, {info.adapter_id: info.rank})
        if self.controller is not None:
            self.controller.adapter_ranks[info.adapter_id] = info.rank
        self._sync_banks(self.orch.placement)   # records the new entry
        self.registered += 1
        return sid

    def unregister_adapter(self, adapter_id: str,
                           now: Optional[float] = None) -> None:
        """Start a loss-free adapter retire: routing stops immediately
        (new requests raise ``UnknownAdapterError``), in-flight requests
        run to completion, then ``poll`` evicts the copies from backend
        banks and purges the store. Raises ``UnknownAdapterError`` for
        adapters that aren't registered (or are already retiring)."""
        if adapter_id not in self.meta or adapter_id in self._retiring:
            raise UnknownAdapterError(adapter_id)
        if now is None:
            now = self._now
        self.orch.begin_retire_adapter(adapter_id)
        self._retiring.add(adapter_id)
        # idle adapters leave at once; busy ones on a later poll
        self._finish_retiring(now)

    def adapter_entries(self) -> List[dict]:
        """Live adapter table (the gateway's ``GET /v1/adapters``):
        rank, phi-weighted placement, per-server tier residency, and
        whether a loss-free retire is in progress."""
        store = self.orch.store
        out = []
        for aid in sorted(self.meta):
            info = self.meta[aid]
            entry = self.orch.placement.get(aid, {})
            servers = {}
            for sid in sorted(set(entry) | store.index.get(aid, set())):
                servers[sid] = {
                    "phi": round(entry.get(sid, 0.0), 6),
                    "tier": store.tier(sid, aid),
                }
            out.append({
                "adapter_id": aid,
                "rank": info.rank,
                "nbytes": info.nbytes,
                "servers": servers,
                "draining": aid in self._retiring,
            })
        return out

    def _finish_retiring(self, now: float) -> None:
        """Complete retires whose adapters have gone quiet: no live
        requests reference them and no store transfer is moving them."""
        if not self._retiring:
            return
        live = None
        for aid in sorted(self._retiring):
            if self.orch.store.inflight_count(aid):
                continue
            if live is None:
                live = {r.adapter_id for r in self.backend.live_requests()}
            if aid in live:
                continue
            for sid in range(self.backend.n_servers):
                if sid in self._retired_at:
                    continue
                if aid in self.backend.hosted_adapters(sid):
                    # may refuse (e.g. a server's last adapter keeps its
                    # bank shape); the stale bank row is harmless and
                    # the store/routing state below is authoritative
                    self.backend.evict_adapter(sid, aid)
            self.orch.finish_retire_adapter(aid)
            self._retiring.discard(aid)
            self.meta.pop(aid, None)
            self.unregistered += 1

    # -- control path (Fig 11 steps 6-7), mid-flight --------------------
    def _sync_banks(self, placement: Placement) -> None:
        """Sync backend banks down to the placement (evictions only —
        newly placed adapters load lazily on their first routed
        request). Runs at *every* timestep, not only when the placement
        changed: an eviction refused while the adapter was in flight
        must be retried once that traffic drains."""
        prev = self.placements[-1]
        if placement != prev:
            self.placements.append(copy.deepcopy(placement))
        want = servers_to_adapters(placement)
        for sid in range(self.backend.n_servers):
            if sid in self._retired_at:
                continue
            wanted = set(want.get(sid, []))
            for aid in list(self.backend.hosted_adapters(sid)):
                if aid not in wanted and aid not in self._retiring:
                    self.backend.evict_adapter(sid, aid)
        self._max_adapters = max(self._max_adapters,
                                 self.orch.store.max_adapters_per_server())
        self._total_bytes = max(self._total_bytes,
                                self.orch.store.total_bytes())

    def _rebalance(self, period: float, now: float,
                   periodic: bool = True) -> None:
        new = self.orch.end_of_timestep(max(period, 1e-9), now=now)
        if periodic:
            self.rebalances += 1
        self._sync_banks(new)

    # -- controller actions (controlplane tick) --------------------------
    def _control_tick(self, now: float) -> None:
        from repro_torch.controlplane import ClusterState
        ctrl = self.controller
        orch = self.orch
        drained = [sid for sid in sorted(orch.draining)
                   if orch.drain_complete(sid)
                   and self.backend.server_load(sid, now) == 0]
        live = [s for s in range(self.backend.n_servers)
                if s not in self._retired_at]
        state = ClusterState(
            now=now,
            active=list(orch.placeable_servers()),
            draining=sorted(orch.draining),
            drained=drained,
            queue_depth={s: self.backend.queue_depth(s) for s in live},
            utilization={s: self.backend.utilization(s, now)
                         for s in live})
        actions = ctrl.tick(state)
        for a in actions:
            if a.kind == "rebalance":
                self.controller_rebalances += 1
                # skip if a periodic rebalance already ran this instant:
                # re-observing a just-cleared window would feed the
                # demand estimator a spurious zero-tps sample
                if now - self._last_reb > 1e-9:
                    self._rebalance(now - self._last_reb, now,
                                    periodic=False)
                    self._last_reb = now
            elif a.kind == "scale-up":
                self.scale_ups += 1
                sid = self.orch.add_server(now)
                bid = self.backend.add_server()
                assert sid == bid, "store/backend server ids diverged"
                self._provisioned_at[sid] = now
                self.per_server_counts.append(0)
                self._sync_banks(self.orch.placement)
            elif a.kind == "drain":
                self.drains += 1
                self.orch.begin_drain(a.server, now=now)
                self._sync_banks(self.orch.placement)
            elif a.kind == "retire":
                self.retires += 1
                self.orch.retire_server(a.server)
                self.backend.retire_server(a.server)
                self._retired_at[a.server] = now
        rec = self.flight_recorder
        if rec is not None:
            inputs = getattr(ctrl, "last_inputs", {})
            # scale decisions and fresh SLO violations each snapshot the
            # span ring with the controller's decision inputs as audit
            for a in actions:
                if a.kind in ("scale-up", "drain"):
                    rec.dump(a.kind, now,
                             {**dataclasses.asdict(a), **inputs})
            violated = bool(inputs.get("violated", False))
            if violated and not self._slo_bad:
                rec.dump("slo-violation", now, dict(inputs))
            self._slo_bad = violated

    # -- token surfacing ---------------------------------------------------
    def _new_tokens(self, req: ServeRequest) -> Tuple:
        """Tokens decoded since the last poll. Real-engine requests
        surface actual token ids from ``req.output``; simulated ones
        surface ``None`` placeholders (the sim models counts, not
        values) at the same cadence."""
        pos = self._stream_pos.get(req.req_id, 0)
        # a continuation's tokens continue the original stream: its
        # counters restart at zero, so offset by the delivered base
        base = self._stream_base.get(req.req_id, 0)
        if req.output:
            cur = base + len(req.output)
            toks = tuple(req.output[pos - base:cur - base])
        else:
            cur = base + req.decoded
            toks = (None,) * max(0, cur - pos)
        if cur > pos:
            self._stream_pos[req.req_id] = cur
        return toks

    # -- the loop body ----------------------------------------------------
    def poll(self, now: Optional[float] = None) -> List[ClusterEvent]:
        """One control-loop tick at ``now``: complete due adapter
        transfers, fire due rebalances and controller ticks, advance
        every backend server once, and return what happened — finish
        and timeout events always, per-token events when the cluster
        was built with ``track_tokens=True``."""
        self.start()
        if now is None:
            now = self.clock()
        if self._tracer_adv is not None:
            self._tracer_adv(now)
        events: List[ClusterEvent] = []
        ctrl = self.controller
        # chaos plane first: due faults land, then heartbeats + the
        # confirmed-dead check (recovery re-dispatches synchronously and
        # queues its token/finish events on _pending_events)
        if self.injector is not None:
            self.injector.poll(now, self)
        self._beat_and_check(now)
        if self._pending_events:
            events.extend(self._pending_events)
            self._pending_events = []
        self._poll_store(now)
        if self.orch.policy.dynamic and now + 1e-12 >= self._next_reb:
            self._rebalance(now - self._last_reb, now)
            self._last_reb = now
            self._next_reb = now + self.rebalance_period
        if ctrl is not None and now + 1e-12 >= self._next_ctick:
            self._control_tick(now)
            self._next_ctick = now + ctrl.config.tick_period
        self.backend.step(now)
        if self.track_tokens:
            for req in self.backend.live_requests():
                toks = self._new_tokens(req)
                if toks:
                    events.append(ClusterEvent("token", req, toks, now))
        for req in self.backend.drain_completed():
            orig = self._cont_orig.pop(req.req_id, None)
            if orig is not None and orig is not req:
                # a finished continuation reports as its original:
                # one request, full output, end-to-end timestamps
                from repro_torch.faults import merge_continuation
                self._stream_base.pop(req.req_id, None)
                merge_continuation(orig, req)
                req = orig
            done_at = req.finish if req.finish >= 0 else now
            self.metrics.record(req)
            self.hub.observe_completion(req, done_at)
            self._finished.append(req)
            if self._record_spans is not None:
                self._record_spans(self.tracer, req)
            if ctrl is not None:
                ctrl.observe_completion(req, done_at)
            toks = self._new_tokens(req) if self.track_tokens else ()
            self._stream_pos.pop(req.req_id, None)
            events.append(ClusterEvent("finish", req, toks, now))
        for req in self.backend.drain_timed_out():
            orig = self._cont_orig.pop(req.req_id, None)
            if orig is not None and orig is not req:
                self._stream_base.pop(req.req_id, None)
                req = orig
            self._timed_out.append(req)
            self.hub.observe_timeout(now)
            if ctrl is not None:
                ctrl.observe_timeout(now)
            self._stream_pos.pop(req.req_id, None)
            if self.flight_recorder is not None:
                self.flight_recorder.dump(
                    "timeout", now,
                    {"req_id": req.req_id,
                     "adapter_id": req.adapter_id,
                     "server": req.server, "arrival": req.arrival})
            events.append(ClusterEvent("timeout", req, (), now))
        self._finish_retiring(now)
        self._now = max(self._now, now)
        self._end_time = max(self._end_time, self._now)
        return events

    def _next_time(self, now: float, arrivals_left: bool,
                   next_arrival: Optional[float] = None
                   ) -> Optional[float]:
        """Earliest future instant anything can happen (virtual-clock
        drivers jump to it); None when the cluster is eternally idle."""
        cands = []
        if next_arrival is not None:
            cands.append(next_arrival)
        t = self.backend.next_event_time(now)
        if t is not None:
            cands.append(t)
        t = self.orch.store.next_event_time(now)
        if t is not None:
            cands.append(t)
        if self.orch.policy.dynamic and (arrivals_left
                                         or self.backend.pending()):
            cands.append(self._next_reb)
        if self.controller is not None and (arrivals_left
                                            or self.backend.pending()
                                            or self.orch.draining):
            cands.append(self._next_ctick)
        if self.injector is not None:
            t = self.injector.next_time()
            if t is not None:
                cands.append(max(t, now))
        if self._crashed:
            # a crashed server's confirmation deadline — virtual clocks
            # must reach it for detection (and recovery) to fire
            t = self.detector.next_deadline(now)
            if t is not None:
                cands.append(t)
        if not cands:
            return None
        return min(cands)

    # -- drain ------------------------------------------------------------
    def drain(self, max_steps: int = 10_000_000) -> List[ClusterEvent]:
        """Finish everything in flight — queued requests, store
        transfers, server drains, adapter retires — without admitting
        new work. Returns every event observed on the way out."""
        self.start()
        events: List[ClusterEvent] = []
        now = self._now
        for _ in range(max_steps):
            if self.backend.realtime:
                now = self.backend.wall_now()
            events.extend(self.poll(now))
            if self.idle():
                break
            if self.backend.realtime:
                time.sleep(0.001)
            else:
                nxt = self._next_time(now, arrivals_left=False)
                if nxt is None:
                    break
                now = max(now, nxt)
        # drain trailing transfers (warm fetches/prefetches still in
        # flight when the last request finished) so the report's bank
        # and remote-residency state is consistent
        self._poll_store(float("inf"))
        self._end_time = max(self._end_time, now)
        return events

    def close(self) -> None:
        """Release backend execution resources (engine banks) after a
        drain. The report must be snapshotted first — retired servers
        report empty memory profiles."""
        if self._closed:
            return
        self._closed = True
        self._poll_store(float("inf"))
        for sid in range(self.backend.n_servers):
            if sid in self._retired_at:
                continue
            self.backend.retire_server(sid)

    # -- batch replay (implemented on submit/poll) -------------------------
    def run(self, trace: List[ServeRequest], *,
            max_steps: int = 10_000_000) -> ClusterReport:
        if self._ran:
            raise RuntimeError("LoRAServeCluster is one-shot; build a "
                               "fresh instance per run")
        self._ran = True
        trace = sorted(trace, key=lambda r: r.arrival)
        n = len(trace)
        self.start()
        now = 0.0
        i = 0
        for _ in range(max_steps):
            self._poll_store(now)
            while i < n and trace[i].arrival <= now + 1e-12:
                self.submit(trace[i], now)
                i += 1
            self.poll(now)
            if i >= n and self.backend.pending() == 0 \
                    and not self.orch.draining:
                break
            if self.backend.realtime:
                if self.backend.pending() == 0 and i < n:
                    time.sleep(max(0.0, min(
                        trace[i].arrival - self.backend.wall_now(), 0.01)))
                now = self.backend.wall_now()
            else:
                nxt = self._next_time(
                    now, i < n, trace[i].arrival if i < n else None)
                if nxt is None:
                    break           # nothing can ever happen again
                now = max(now, nxt)
        self._poll_store(float("inf"))
        self._end_time = now
        return self._report(trace)

    # -- reporting ---------------------------------------------------------
    def snapshot(self) -> ClusterReport:
        """Mid-flight report over everything submitted so far —
        unfinished requests appear with ``finished=False`` and none of
        the percentile helpers raise on the partial window. This is
        what feeds a live ``/metrics`` scrape; it does not require (or
        wait for) the run to complete."""
        return self._report(list(self._submitted))

    def report(self) -> ClusterReport:
        """Final report over every submitted request."""
        return self._report(list(self._submitted))

    def _report(self, reqs: List[ServeRequest]) -> ClusterReport:
        if self.tracer is not None:
            flush = getattr(self.backend, "flush_spans", None)
            if flush is not None:
                flush()     # staged (coalesced) decode spans
        done_ids = {id(r) for r in self._finished}
        results = []
        for r in reqs:
            finished = id(r) in done_ids
            results.append(ServeResult(
                req_id=r.req_id, adapter_id=r.adapter_id, rank=r.rank,
                server=r.server, arrival=r.arrival, finished=finished,
                ttft=r.ttft if finished else None,
                tbt=r.tbt if finished else None,
                fetch_latency=r.fetch_latency,
                n_output=len(r.output) if r.output else r.decoded))
        store = self.orch.store
        if self.orch.policy.replicate_all:
            max_adapters = len(self.adapters)
            total_bytes = sum(a.nbytes for a in self.adapters) \
                * self.backend.n_servers
        else:
            max_adapters = max(self._max_adapters,
                               store.max_adapters_per_server())
            total_bytes = max(self._total_bytes, store.total_bytes())
        end = max(self._end_time, self._now)
        gpu_seconds = sum(
            self._retired_at.get(sid, end) - t0
            for sid, t0 in self._provisioned_at.items())
        return ClusterReport(
            results=results,
            summary=self.metrics.summary(),
            rebalances=self.rebalances,
            placements=self.placements,
            per_server_counts=list(self.per_server_counts),
            timed_out=len(self._timed_out),
            fetches=store.fetches,
            fetch_bytes=store.fetch_bytes,
            max_adapters_per_server=max_adapters,
            total_adapter_bytes=total_bytes,
            memory_profile=self.backend.memory_profile(),
            warmup=self.warmup,
            bank_mode=getattr(self.backend, "bank_mode", "padded"),
            mesh_shape=getattr(self.backend, "mesh_shape", None),
            in_progress=sum(1 for r in results if not r.finished),
            access_mode=self.access_mode,
            remote_reads=store.remote_reads,
            prefetches=store.prefetches,
            coalesced_fetches=store.coalesced,
            registered=self.registered,
            unregistered=self.unregistered,
            scale_ups=self.scale_ups,
            drains=self.drains,
            retires=self.retires,
            controller_rebalances=self.controller_rebalances,
            gpu_seconds=gpu_seconds,
            final_servers=len(self.orch.placeable_servers()),
            drift_events=(list(self.controller.detector.events)
                          if self.controller is not None else []),
            controller_actions=(list(self.controller.actions)
                                if self.controller is not None else []),
            cost_drift=(self.cost_drift.summary()
                        if self.cost_drift is not None else {}),
            trace_spans=(self.tracer.n_spans
                         if self.tracer is not None else 0),
            flight_dumps=(self.flight_recorder.n_dumps
                          if self.flight_recorder is not None else 0),
            server_failures=self.server_failures,
            recoveries=self.recoveries,
            redispatched=self.redispatched,
            cancelled=self.cancelled,
            fetch_retries=store.fetch_retries,
            fetch_timeouts=store.fetch_timeouts,
            breaker_opens=sum(b.opens for b in store.breakers.values()),
            recovery_records=list(self.recovery_records),
        )
