"""A copy of the JAX package's ``cluster/simulator.py``.

Discrete-event cluster simulator: trace in, per-request TTFT/TBT out.

Wires together the LORASERVE orchestrator (placement policy + routing
table + tiered adapter store + demand estimator) with a pool of
iteration-level SimServers, advancing time with a simple event loop.
Rebalancing timesteps fire every `rebalance_period` seconds for dynamic
policies (paper Fig 11 step 6-7).

Adapter movement is asynchronous: a miss starts a transfer through the
``AdapterStore`` that occupies link bandwidth until a "fetch" event
completes it. ``access_mode="migrate"`` blocks the request until the
copy lands (``ready = eta``); ``"remote-read"`` starts serving
immediately from a peer's copy over GDR, paying a per-iteration penalty
until the background warm fetch finishes. ``prefetch=True`` warms
newly-placed copies at each rebalance instead of migrating lazily.

With a ``ClusterController`` attached the fleet itself becomes dynamic:
"ctick" events on the event clock feed windowed telemetry into the
drift detector and SLO tracker, and the returned actions provision new
``SimServer``s (after ``provision_delay``), drain servers (placement
re-solved without them, holdings migrated out through the store, no new
routes), and retire emptied ones. ``SimResult.gpu_seconds`` bills each
server from provisioning to retirement (or end of run) — the paper's
fewer-GPUs-under-SLO metric.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional, Set

from repro_torch.core.baselines import POLICIES
from repro_torch.core.demand import DemandEstimator
from repro_torch.core.pool import AdapterStore, runtime_checks_enabled
from repro_torch.core.routing import RoutingTable
from repro_torch.core.types import AdapterInfo, PlacementContext
from repro_torch.faults.plan import (KIND_CRASH, KIND_LINK_DEGRADE,
                                     KIND_LINK_DOWN, KIND_LINK_UP,
                                     KIND_RESTORE, KIND_STALL_FETCH)
from repro_torch.faults.recovery import (RecoveryRecord, make_continuation,
                                         merge_continuation, remaining_tokens)

from .costmodel import ServerModel, profile_operating_points
from .network import NetworkModel
from .server import SimRequest, SimServer


@dataclasses.dataclass
class SimResult:
    requests: List[SimRequest]
    fetches: int
    fetch_bytes: int
    max_adapters_per_server: int
    total_adapter_bytes: int
    server_busy: List[float]
    rebalances: int
    timed_out: int
    per_server_p95_ttft: List[float]
    warmup: float = 0.0     # requests arriving before this are excluded
    # adapter data-plane telemetry
    remote_reads: int = 0        # misses served via peer GDR reads
    prefetches: int = 0          # rebalance-driven proactive warms
    coalesced_fetches: int = 0   # duplicate fetches joined in flight
    # control-plane telemetry (controller runs only)
    scale_ups: int = 0
    drains: int = 0
    retires: int = 0
    controller_rebalances: int = 0   # out-of-band (drift/SLO) rebalances
    gpu_seconds: float = 0.0         # sum over servers of billed time
    final_servers: int = 0           # active fleet size at end of run
    drift_events: List = dataclasses.field(default_factory=list)
    actions: List = dataclasses.field(default_factory=list)
    # observability (tracer-attached runs only): per-phase modeled vs
    # measured iteration error — exactly 0 on this substrate (sim time
    # IS the model; nonzero means the span plumbing broke)
    cost_drift: dict = dataclasses.field(default_factory=dict)
    trace_spans: int = 0
    flight_dumps: int = 0
    # chaos plane (fault_plan runs only)
    server_failures: int = 0
    recoveries: int = 0
    redispatched: int = 0            # stranded requests re-issued
    fetch_retries: int = 0
    fetch_timeouts: int = 0
    breaker_opens: int = 0
    recovery_records: List = dataclasses.field(default_factory=list)

    def _eligible(self):
        return [r for r in self.requests if r.arrival >= self.warmup]

    def _ttfts(self):
        return sorted(r.ttft for r in self._eligible()
                      if r.prefill_done >= 0)

    def p95_ttft(self) -> float:
        t = self._ttfts()
        return t[int(0.95 * (len(t) - 1))] if t else float("inf")

    def p50_ttft(self) -> float:
        t = self._ttfts()
        return t[len(t) // 2] if t else float("inf")

    def mean_tbt(self) -> float:
        ts = [r.tbt for r in self._eligible()
              if r.finish >= 0 and r.tbt > 0]
        return sum(ts) / len(ts) if ts else 0.0

    def p95_tbt(self) -> float:
        ts = sorted(r.tbt for r in self._eligible()
                    if r.finish >= 0 and r.tbt > 0)
        return ts[int(0.95 * (len(ts) - 1))] if ts else 0.0

    def completed(self) -> int:
        return sum(1 for r in self.requests if r.finish >= 0)

    def meets_slo(self, slo_ttft: float) -> bool:
        return self.timed_out == 0 and self.p95_ttft() <= slo_ttft

    def slo_attainment(self, slo_ttft: float) -> float:
        """Fraction of eligible requests finishing prefill within the
        TTFT target; dropped/unfinished requests count as misses."""
        elig = self._eligible()
        if not elig:
            return 1.0
        ok = sum(1 for r in elig
                 if r.prefill_done >= 0 and r.ttft <= slo_ttft)
        return ok / len(elig)

    def gpu_hours(self) -> float:
        return self.gpu_seconds / 3600.0


class ClusterSimulator:
    def __init__(self, n_servers: int, adapters: List[AdapterInfo],
                 policy: str = "loraserve",
                 server_model: Optional[ServerModel] = None,
                 rebalance_period: float = 15.0,
                 timeout: float = 120.0,
                 warmup: float = 0.0,
                 seed: int = 0,
                 bank_mode: str = "padded",
                 decode_block: int = 1,
                 access_mode: str = "migrate",
                 prefetch: bool = False,
                 network: Optional[NetworkModel] = None,
                 controller=None,
                 provision_delay: float = 0.0,
                 tracer=None, flight_recorder=None,
                 fault_plan=None,
                 detector_window: float = 0.5,
                 durable_ssd: bool = False,
                 retry_policy=None):
        if access_mode not in ("migrate", "remote-read"):
            raise ValueError(f"unknown access_mode {access_mode!r}")
        self.warmup = warmup
        # closed-loop control plane (repro.controlplane): fed telemetry
        # on the event clock, may grow/drain/retire the fleet mid-run
        self.controller = controller
        self.provision_delay = provision_delay
        self.bank_mode = bank_mode
        self.decode_block = decode_block
        self.access_mode = access_mode
        self.prefetch = prefetch
        self.n = n_servers
        self.adapters = adapters
        self.meta = {a.adapter_id: a for a in adapters}
        self.model = server_model or ServerModel()
        self.policy = POLICIES[policy]() if isinstance(policy, str) \
            else policy
        self.network = network or NetworkModel()
        self.rebalance_period = rebalance_period
        self.timeout = timeout
        self.seed = seed
        ranks = {a.rank for a in adapters}
        self.operating_points = profile_operating_points(self.model, ranks)
        # observability: span tracing on the event clock, per-phase
        # modeled-vs-measured drift, and flight-recorder dumps on
        # controller scale decisions / timeouts
        # chaos plane: seeded fault schedule on the event clock; crashes
        # are detected after one heartbeat window (the wall-clock facade
        # runs a real FailureDetector — here detection latency is
        # modeled directly as `detector_window` seconds of silence)
        self.fault_plan = fault_plan
        self.detector_window = detector_window
        self.durable_ssd = durable_ssd
        self.retry_policy = retry_policy
        self.tracer = tracer
        self.flight_recorder = flight_recorder
        self.cost_drift = None
        if tracer is not None:
            from repro_torch.obs import CostModelDrift
            self.cost_drift = CostModelDrift(self.model)
            tracer.add_listener(self.cost_drift.observe)
            if flight_recorder is not None:
                tracer.add_listener(flight_recorder.observe)

    def run(self, trace: List[SimRequest]) -> SimResult:
        tracer = self.tracer
        recorder = self.flight_recorder
        record_spans = None
        clock_adv = (getattr(tracer.clock, "advance", None)
                     if tracer is not None else None)
        if tracer is not None:
            from repro_torch.obs import record_request_spans
            record_spans = record_request_spans
        servers = [SimServer(i, self.model, bank_mode=self.bank_mode,
                             decode_block=self.decode_block,
                             tracer=tracer)
                   for i in range(self.n)]
        ctrl = self.controller
        if ctrl is not None:   # lazy: keeps controller-less sims light
            from repro_torch.controlplane import ClusterState
            # hand the controller the paper's capacity model so its
            # drain gate can run Algorithm-1 demand math
            if ctrl.operating_points is None:
                ctrl.operating_points = self.operating_points
            if not ctrl.adapter_ranks:
                ctrl.adapter_ranks = {a.adapter_id: a.rank
                                      for a in self.adapters}
        active: Set[int] = set(range(self.n))      # serving servers
        draining: Set[int] = set()                 # emptying, no routes
        provisioned_at: Dict[int, float] = {i: 0.0 for i in range(self.n)}
        retired_at: Dict[int, float] = {}
        prev_busy: Dict[int, float] = {}    # ctick utilization baseline
        demand = DemandEstimator()
        # initial placement from uniform demand prior
        ctx = PlacementContext(
            n_servers=self.n, adapters=self.adapters,
            demand_tps={a.adapter_id: 1.0 for a in self.adapters},
            operating_points=self.operating_points)
        placement = self.policy.place(ctx)
        router = RoutingTable(placement, seed=self.seed)
        pool = AdapterStore(self.n, self.adapters, self.network,
                            retry=self.retry_policy,
                            durable_ssd=self.durable_ssd)
        pool.tracer = tracer
        pool.seed(placement)
        max_adapters = pool.max_adapters_per_server()
        total_bytes = pool.total_bytes()

        trace = sorted(trace, key=lambda r: r.arrival)
        window_tokens: Dict[str, float] = {}
        rebalances = 0
        ctrl_rebalances = 0
        scale_ups = drains = retires = 0
        timed_out = 0
        last_rb = 0.0
        # chaos plane: crashed servers freeze (fail-stop — stranded work
        # neither runs nor times out) until detection one heartbeat
        # window later; recovery re-places adapters and re-dispatches
        # stranded requests as same-req_id continuations
        failed: Set[int] = set()            # crashed (detected or not)
        dead_detected: Set[int] = set()     # recovery already ran
        failed_at: Dict[int, float] = {}
        cont_orig: Dict[int, SimRequest] = {}   # req_id -> original
        server_failures = recoveries = redispatched_n = 0
        recovery_records: List = []

        # event heap entries: (time, seq, kind, payload)
        heap: list = []
        seq = 0
        remaining_arrivals = len(trace)
        for r in trace:
            heapq.heappush(heap, (r.arrival, seq, "arrival", r))
            seq += 1
        if self.policy.dynamic:
            heapq.heappush(heap, (self.rebalance_period, seq,
                                  "rebalance", None))
            seq += 1
        if ctrl is not None:
            heapq.heappush(heap, (ctrl.config.tick_period, seq,
                                  "ctick", None))
            seq += 1
        if self.fault_plan is not None:
            self.fault_plan.reset()
            for ev in self.fault_plan.events:
                heapq.heappush(heap, (ev.time, seq, "fault", ev))
                seq += 1

        def schedule_server(s: SimServer, now: float):
            nonlocal seq
            t = s.next_event_time(now)
            if t is not None:
                heapq.heappush(heap, (max(t, now), seq, "server", s.sid))
                seq += 1

        def push(t: float, kind: str, payload=None):
            nonlocal seq
            heapq.heappush(heap, (t, seq, kind, payload))
            seq += 1

        def push_fetch(eta: float):
            push(eta, "fetch")

        def work_remains() -> bool:
            """Whether recurring events (rebalance/ctick) should keep
            firing: arrivals still due, requests in flight, or adapter
            transfers on the wire. (`if heap:` is not enough once two
            recurring events coexist — they would sustain each other
            forever.)"""
            return (remaining_arrivals > 0
                    or any(s.waiting or s.running for s in servers)
                    or pool.inflight_count() > 0)

        def feed_completions():
            """Drain per-server completion feeds into the controller
            (stamped at the request's own finish time) and the tracer
            (canonical per-request span trees — the same helper the
            engine facade uses, so span names match across substrates).

            Also the event clock's pace point: spans carry explicit
            timestamps, so the tracer clock only needs to track event
            time here — advancing it on every heap pop costs ~10% of
            the whole sim (most pops are busy-wait re-pushes)."""
            if clock_adv is not None:
                clock_adv(now)
            for s in servers:
                if not s.finished:
                    continue
                for r in s.finished:
                    # a finished continuation folds back into the
                    # original trace object (same req_id, full output)
                    orig = cont_orig.pop(r.req_id, None)
                    if orig is not None and orig is not r:
                        merge_continuation(orig, r)
                        r = orig
                    if ctrl is not None:
                        ctrl.observe_completion(r, r.finish)
                    if record_spans is not None:
                        record_spans(tracer, r)
                s.finished.clear()

        def do_rebalance(now: float):
            """Close the demand window and re-solve placement over the
            currently-active fleet (paper Fig 11 steps 6-7, on whatever
            servers the control plane has left us). A second call at the
            same instant (controller rebalance coinciding with the
            periodic one, or rebalance+drain in one tick) re-solves but
            must not feed a spurious zero-demand sample."""
            nonlocal last_rb, max_adapters, placement
            period = now - last_rb
            if period > 1e-9:
                for aid in self.meta:
                    demand.observe(aid,
                                   window_tokens.get(aid, 0.0) / period)
                window_tokens.clear()
                last_rb = now
            placeable = sorted(active)
            ctx = PlacementContext(
                n_servers=len(placeable), adapters=self.adapters,
                demand_tps=demand.demands(list(self.meta)),
                operating_points=self.operating_points,
                prev_placement=placement, server_ids=placeable)
            placement = self.policy.place(ctx)
            router.update(placement)
            for p in pool.apply_placement(placement, now=now,
                                          prefetch=self.prefetch):
                push_fetch(p.eta)
            max_adapters = max(max_adapters,
                               pool.max_adapters_per_server())

        def drained_servers(now: float) -> List[int]:
            """Draining servers that are now empty: no queued/running
            work, no HBM copies, not feeding or receiving transfers."""
            out = []
            for sid in sorted(draining):
                s = servers[sid]
                if s.waiting or s.running:
                    continue
                if pool.server_adapter_count(sid) or \
                        pool.inflight_from(sid) or pool.inflight_to(sid):
                    continue
                out.append(sid)
            return out

        def execute(actions, now: float):
            nonlocal ctrl_rebalances, scale_ups, drains, retires
            if recorder is not None:
                inputs = getattr(ctrl, "last_inputs", {})
                for a in actions:
                    if a.kind in ("scale-up", "drain"):
                        recorder.dump(a.kind, now,
                                      {**dataclasses.asdict(a), **inputs})
            for a in actions:
                if a.kind == "rebalance":
                    ctrl_rebalances += 1
                    do_rebalance(now)
                elif a.kind == "scale-up":
                    scale_ups += 1
                    # billed from the request; serving from provision
                    push(now + self.provision_delay, "provision", now)
                elif a.kind == "drain":
                    drains += 1
                    active.discard(a.server)
                    draining.add(a.server)
                    do_rebalance(now)       # re-place without the victim
                    for p in pool.drain_server(a.server, now):
                        push_fetch(p.eta)
                elif a.kind == "retire":
                    retires += 1
                    pool.retire_server(a.server)
                    router.block_server(a.server)
                    draining.discard(a.server)
                    retired_at[a.server] = now

        def dispatch(req: SimRequest, now: float) -> int:
            """Route + enqueue one request (fresh arrival or recovery
            continuation) on the currently-active fleet."""
            if self.policy.replicate_all:
                sid = min(sorted(active),
                          key=lambda i: servers[i].estimated_work(now))
                router.request_counts[req.adapter_id] = \
                    router.request_counts.get(req.adapter_id, 0) + 1
                req.ready = now
                req.fetch_latency = 0.0
            else:
                sid, entry = router.route_detailed(
                    req.adapter_id,
                    tokens=req.prompt_len + req.output_len)
                plan = pool.plan_access(
                    sid, req.adapter_id, now=now,
                    access_mode=self.access_mode,
                    preferred_peers=[s for s, _ in entry])
                req.apply_fetch_plan(plan, now)
                if not plan.hit:
                    push_fetch(plan.eta)
            req.server = sid
            req.rank = self.meta[req.adapter_id].rank
            servers[sid].enqueue(req)
            schedule_server(servers[sid], now)
            return sid

        def redispatch(req: SimRequest, now: float) -> bool:
            """Exactly-once re-dispatch of a stranded request: issue a
            same-``req_id`` continuation for the undelivered suffix on
            a survivor; a request that already decoded every token is
            finalized in place."""
            nonlocal redispatched_n, timed_out
            orig = cont_orig.pop(req.req_id, None)
            if orig is not None and orig is not req:
                # a continuation itself stranded: fold its progress back
                # and re-continue from the original
                merge_continuation(orig, req)
                orig.finish = -1.0
                req = orig
            if remaining_tokens(req) <= 0:
                req.finish = now
                if req.prefill_done < 0:
                    req.prefill_done = now
                if ctrl is not None:
                    ctrl.observe_completion(req, now)
                return False
            cont = make_continuation(req, now)
            cont_orig[cont.req_id] = req
            dispatch(cont, now)
            redispatched_n += 1
            return True

        def recover(sid: int, now: float):
            """Detection fired one heartbeat window after the crash:
            block routing, re-place the dead server's adapters onto
            survivors (prefetch re-warms, SSD recovers last-copy loss
            when ``durable_ssd``), re-dispatch its stranded requests."""
            nonlocal recoveries
            feed_completions()
            s = servers[sid]
            stranded = list(s.waiting) + list(s.running)
            s.waiting.clear()
            s.running.clear()
            s.busy_until = 0.0
            active.discard(sid)
            draining.discard(sid)
            orphans = pool.fail_server(sid, now)
            keep_prefetch = self.prefetch
            self.prefetch = True      # recovery re-warm is never lazy
            try:
                do_rebalance(now)
            finally:
                self.prefetch = keep_prefetch
            router.block_server(sid)
            dead_detected.add(sid)
            if ctrl is not None and hasattr(ctrl, "observe_failure"):
                ctrl.observe_failure(sid, now)
            redone = 0
            for req in sorted(stranded, key=lambda r: r.req_id):
                if redispatch(req, now):
                    redone += 1
            recoveries += 1
            recovery_records.append(RecoveryRecord(
                server=sid, detected_at=now, recovered_at=now,
                redispatched=redone, orphaned_adapters=len(orphans)))
            if recorder is not None:
                recorder.dump("fault-recover", now,
                              {"server": sid, "stranded": len(stranded),
                               "redispatched": redone,
                               "orphans": len(orphans),
                               "crashed_at": failed_at.get(sid, now)})

        def apply_fault(ev, now: float):
            """One FaultPlan event on the sim's virtual clock. Crash
            semantics are fail-stop: the backend freezes immediately,
            but placement/routing only learn at detection."""
            nonlocal server_failures, seq
            sid = ev.target
            if ev.kind == KIND_CRASH:
                if not (0 <= sid < len(servers)) or sid in failed \
                        or sid in retired_at:
                    return
                failed.add(sid)
                failed_at[sid] = now
                server_failures += 1
                push(now + self.detector_window, "recover", sid)
                if recorder is not None:
                    recorder.dump("fault-crash", now, {"server": sid})
            elif ev.kind == KIND_RESTORE:
                if sid in failed and sid not in dead_detected:
                    # flapped back inside the detection window: frozen
                    # work simply resumes, no recovery ran
                    failed.discard(sid)
                    failed_at.pop(sid, None)
                    schedule_server(servers[sid], now)
                elif sid in dead_detected:
                    failed.discard(sid)
                    dead_detected.discard(sid)
                    pool.restore_server(sid)
                    router.unblock_server(sid)
                    active.add(sid)
                    do_rebalance(now)   # fold the survivor back in
                if recorder is not None:
                    recorder.dump("fault-restore", now, {"server": sid})
            elif ev.kind == KIND_LINK_DOWN:
                self.network.set_link_down(sid)
            elif ev.kind == KIND_LINK_UP:
                self.network.set_link_up(sid)
                self.network.reset_link(sid)
            elif ev.kind == KIND_LINK_DEGRADE:
                self.network.degrade_link(sid, max(1.0, ev.arg))
            elif ev.kind == KIND_STALL_FETCH:
                for (dest, aid), p in sorted(pool._inflight.items()):
                    if p.retry_at >= 0 or p.stalled:
                        continue
                    if sid >= 0 and dest != sid and p.src_server != sid:
                        continue
                    pool.stall_transfer(
                        dest, aid,
                        ev.arg if ev.arg > 0 else float("inf"))
                    t = pool.next_event_time(now)
                    if t is not None:
                        push_fetch(t)   # drive the timeout/retry path
                    break

        now = 0.0
        last_activity = 0.0
        # REPRO_CHECK_INVARIANTS=1: re-check the protocol checker's
        # store+routing invariants on a stride of events (debug-only;
        # the env gate keeps the hot loop free of the sweep otherwise).
        # The store already self-checks on every poll/start_fetch edge,
        # so the stride only paces the routing-table cross-check — a
        # full sweep per event is O(adapters x servers) and makes the
        # large sims unusably slow.
        debug_invariants = runtime_checks_enabled()
        debug_stride = 64
        n_events = 0
        while heap:
            now, _, kind, payload = heapq.heappop(heap)
            if kind == "provision" and not work_remains():
                continue    # run drained while the server booted:
                #             nothing to serve, nothing to bill
            last_activity = now
            n_events += 1
            if debug_invariants and n_events % debug_stride == 0:
                pool.check_invariants(now, routing=router,
                                      raise_on_violation=True)
            if kind == "arrival":
                req: SimRequest = payload
                remaining_arrivals -= 1
                sid = dispatch(req, now)
                tokens = req.prompt_len + req.output_len
                window_tokens[req.adapter_id] = \
                    window_tokens.get(req.adapter_id, 0.0) + tokens
                if ctrl is not None:
                    ctrl.observe_arrival(req.adapter_id, sid, tokens, now)
            elif kind == "fetch":
                for p in pool.poll(now):
                    # the retry path moves landings past the ETA
                    # stamped at dispatch (a stalled attempt even
                    # quotes eta=inf to coalescing requests): now that
                    # the copy actually landed, re-stamp any request
                    # still waiting on the stale quote and wake the
                    # server, or it blocks forever on a time that
                    # never comes
                    if p.dest >= len(servers):
                        continue
                    s = servers[p.dest]
                    woke = False
                    for r in s.waiting:
                        if r.adapter_id == p.adapter_id and \
                                r.ready > now + 1e-12:
                            r.fetch_latency = max(0.0, now - r.arrival)
                            r.ready = now
                            woke = True
                    if woke:
                        schedule_server(s, now)
                # retries (timeout -> backoff -> relaunch) move the next
                # wakeup off any plan's original eta: chain the next
                # pending store event so the retry path always fires
                t = pool.next_event_time(now)
                if t is not None and t > now + 1e-12:
                    push_fetch(t)
            elif kind == "fault":
                apply_fault(payload, now)
            elif kind == "recover":
                if payload in failed and payload not in dead_detected:
                    recover(payload, now)
            elif kind == "server":
                if payload in failed:
                    continue    # fail-stop freeze: nothing runs, and
                    #             stranded work does not time out
                s = servers[payload]
                if s.busy_until > now + 1e-12:
                    push(s.busy_until, "server", s.sid)
                    continue
                # drop timed-out waiting requests
                for r in list(s.waiting):
                    if now - r.arrival > self.timeout:
                        s.waiting.remove(r)
                        timed_out += 1
                        if ctrl is not None:
                            ctrl.observe_timeout(now)
                        if recorder is not None:
                            recorder.dump(
                                "timeout", now,
                                {"req_id": r.req_id,
                                 "adapter_id": r.adapter_id,
                                 "server": r.server,
                                 "arrival": r.arrival})
                if s.has_work(now):
                    end = s.step(now)
                    feed_completions()
                    if end > now or s.waiting or s.running:
                        push(end, "server", s.sid)
                else:
                    if s.waiting:
                        schedule_server(s, now + 1e-9)
            elif kind == "rebalance":
                rebalances += 1
                do_rebalance(now)
                # reschedule only while *request* work remains. The
                # work_remains() predicate also counts in-flight
                # transfers — including the ones do_rebalance itself
                # just launched — so gating on it lets a near-zero
                # demand window ping-pong placement forever after the
                # trace drains (each rebalance's own transfers keep the
                # next one alive). Transfers complete through the fetch
                # event chain regardless.
                if remaining_arrivals > 0 or \
                        any(s.waiting or s.running for s in servers):
                    push(now + self.rebalance_period, "rebalance")
            elif kind == "ctick":
                feed_completions()
                # queue depth = *waiting* requests only: with continuous
                # batching a healthy server legitimately runs a full
                # decode batch; backlog is what gates drains
                period = ctrl.config.tick_period
                util = {}
                for s in servers:
                    if s.sid in retired_at:
                        continue
                    prev = prev_busy.get(s.sid, 0.0)
                    util[s.sid] = min(1.0, max(
                        0.0, (s.busy_time - prev) / period))
                    prev_busy[s.sid] = s.busy_time
                state = ClusterState(
                    now=now, active=sorted(active),
                    draining=sorted(draining),
                    drained=drained_servers(now),
                    queue_depth={s.sid: float(len(s.waiting))
                                 for s in servers
                                 if s.sid not in retired_at},
                    utilization=util)
                execute(ctrl.tick(state), now)
                if work_remains() or draining:
                    push(now + ctrl.config.tick_period, "ctick")
            elif kind == "provision":
                sid = pool.add_server()
                servers.append(SimServer(sid, self.model,
                                         bank_mode=self.bank_mode,
                                         decode_block=self.decode_block,
                                         tracer=tracer))
                active.add(sid)
                provisioned_at[sid] = payload    # billed from request
                do_rebalance(now)   # fold the new server into placement
        for s in servers:
            s.flush_spans()          # staged (coalesced) decode spans
        feed_completions()           # trailing finishes, if any

        if self.policy.replicate_all:
            max_adapters = len(self.adapters)
            total_bytes = sum(a.nbytes for a in self.adapters) * self.n
        else:
            max_adapters = max(max_adapters, pool.max_adapters_per_server())
            total_bytes = max(total_bytes, pool.total_bytes())

        end_time = last_activity
        gpu_seconds = sum(retired_at.get(sid, end_time) - t0
                          for sid, t0 in provisioned_at.items())
        per_server = []
        for s in servers:
            ts = sorted(r.ttft for r in trace
                        if r.server == s.sid and r.prefill_done >= 0)
            per_server.append(ts[int(0.95 * (len(ts) - 1))] if ts else 0.0)
        return SimResult(
            requests=trace,
            fetches=pool.fetches,
            fetch_bytes=pool.fetch_bytes,
            max_adapters_per_server=max_adapters,
            total_adapter_bytes=total_bytes,
            server_busy=[s.busy_time for s in servers],
            rebalances=rebalances,
            timed_out=timed_out,
            per_server_p95_ttft=per_server,
            warmup=self.warmup,
            remote_reads=pool.remote_reads,
            prefetches=pool.prefetches,
            coalesced_fetches=pool.coalesced,
            scale_ups=scale_ups,
            drains=drains,
            retires=retires,
            controller_rebalances=ctrl_rebalances,
            gpu_seconds=gpu_seconds,
            final_servers=len(active),
            drift_events=(list(ctrl.detector.events)
                          if ctrl is not None else []),
            actions=list(ctrl.actions) if ctrl is not None else [],
            cost_drift=(self.cost_drift.summary()
                        if self.cost_drift is not None else {}),
            trace_spans=tracer.n_spans if tracer is not None else 0,
            flight_dumps=recorder.n_dumps if recorder is not None else 0,
            server_failures=server_failures,
            recoveries=recoveries,
            redispatched=redispatched_n,
            fetch_retries=pool.fetch_retries,
            fetch_timeouts=pool.fetch_timeouts,
            breaker_opens=sum(b.opens for b in pool.breakers.values()),
            recovery_records=recovery_records,
        )


def max_rps_under_slo(make_trace, n_servers: int, adapters, policy: str,
                      slo_ttft: float = 10.0, rps_grid=None, **sim_kw):
    """Paper's 'throughput under SLO' metric: max RPS whose P95 TTFT
    meets the SLO. `make_trace(rps)` builds the trace."""
    best = 0.0
    for rps in (rps_grid or [4, 8, 12, 16, 20, 24, 28, 32, 36, 40]):
        sim = ClusterSimulator(n_servers, adapters, policy=policy, **sim_kw)
        res = sim.run(make_trace(rps))
        if res.meets_slo(slo_ttft):
            best = rps
        else:
            break
    return best


def min_servers_under_slo(make_trace, adapters, policy: str, rps: float,
                          slo_ttft: float = 10.0, max_servers: int = 16,
                          **sim_kw):
    """Paper's GPU-savings metric: smallest cluster meeting the SLO."""
    for n in range(1, max_servers + 1):
        sim = ClusterSimulator(n, adapters, policy=policy, **sim_kw)
        res = sim.run(make_trace(rps))
        if res.meets_slo(slo_ttft):
            return n
    return max_servers + 1
