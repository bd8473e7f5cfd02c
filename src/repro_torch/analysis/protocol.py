"""Exhaustive-interleaving model checker for the adapter / control-plane
state machines of the PyTorch port: a copy of the JAX package's
``analysis/protocol.py`` driving the port's copies of
``core.pool.AdapterStore``, ``cluster.network.NetworkModel`` and
``core.routing.RoutingTable`` through every interleaving of a bounded
action alphabet (access / rebalance / scale-up / drain / retire / crash /
restore / fetch stall / clock advance), breadth-first over canonicalized
states, and checking the cluster's safety and liveness invariants at
every reachable state: inflight-src-resident (GC never frees an
in-flight transfer's source: the GC-vs-fetch race, re-found when
the ``_gc`` guard is removed), min-copy / index-consistent /
tier-exclusive, retired-silent, link-occupancy, drain-termination and
fetch-liveness.

The invariants themselves are ``core/invariants.py:
check_store_invariants``, which ``AdapterStore.check_invariants`` and the
opt-in ``REPRO_CHECK_INVARIANTS=1`` hook share; this module keeps no copy
of them. No external dependencies: states are deep-copied real objects,
keyed clock-relative and telemetry-free.
"""
from __future__ import annotations

import copy
import dataclasses
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.invariants import check_store_invariants

_EPS = 1e-12


# --------------------------------------------------------------------------
# The model
# --------------------------------------------------------------------------


@dataclasses.dataclass
class ModelConfig:
    """A bounded protocol model: initial fleet + action alphabet."""
    n_servers: int = 2
    adapters: Tuple[Tuple[str, int], ...] = (("a0", 64 << 20),
                                             ("a1", 64 << 20))
    seed_placement: Optional[dict] = None
    rebalance_templates: Tuple[dict, ...] = ()
    max_servers: int = 3          # add_server enabled below this
    enable_add_server: bool = True
    enable_drain: bool = False
    max_depth: int = 8
    max_states: int = 200_000
    host_cache_bytes: int = 512 << 20
    store_cls: Optional[type] = None   # test hook: inject a buggy store
    fabric: str = "ib_gdr"
    enable_crash: bool = False         # crash_server / restore_server
    enable_stall: bool = False         # fetch_timeout (stall + retry)
    durable_ssd: bool = False          # SSD recovers last-copy loss


@dataclasses.dataclass
class Violation:
    invariant: str
    message: str
    trace: Tuple[str, ...]


@dataclasses.dataclass
class CheckResult:
    states: int
    transitions: int
    violations: List[Violation]
    truncated: bool = False       # state/depth cap hit: NOT exhaustive

    @property
    def ok(self) -> bool:
        return not self.violations


class World:
    """One model state: real store + network + routing + a clock."""

    def __init__(self, cfg: ModelConfig):
        from repro_torch.cluster.network import NetworkModel
        from repro_torch.core.pool import AdapterStore
        from repro_torch.core.routing import RoutingTable
        from repro_torch.core.types import AdapterInfo

        self.cfg = cfg
        infos = [AdapterInfo(aid, rank=8, nbytes=nb)
                 for aid, nb in cfg.adapters]
        store_cls = cfg.store_cls or AdapterStore
        self.network = NetworkModel(fabric=cfg.fabric)
        self.store = store_cls(cfg.n_servers, infos,
                               network=self.network,
                               host_cache_bytes=cfg.host_cache_bytes,
                               durable_ssd=cfg.durable_ssd)
        placement = cfg.seed_placement or {
            aid: {i % cfg.n_servers: 1.0}
            for i, (aid, _) in enumerate(cfg.adapters)}
        self.store.seed(placement)
        self.routing = RoutingTable(placement)
        self.now = 0.0

    def clone(self) -> "World":
        return copy.deepcopy(self)

    # -- canonical state key (clock-relative, telemetry-free) -----------
    def key(self) -> tuple:
        s = self.store
        # ETA abstraction: completion *rank* plus a coarse (1 ms) grid
        # bucket. Exact clock-relative offsets accumulate unboundedly
        # many distinct values (every overlap shifts them), while the
        # protocol's decisions depend only on completion order and link
        # load — which rank+bucket preserve — so this keeps the BFS
        # finite without hiding interleavings.
        pending = sorted({round(p.eta - self.now, 9)
                          for p in s._inflight.values()
                          if self.now + _EPS < p.eta < float("inf")})
        def rel(t: float) -> tuple:
            if t == float("inf"):     # stalled / retry-wait sentinel
                return (10 ** 9, -1)
            if t <= self.now + _EPS:
                return (-1, 0)
            r = round(t - self.now, 9)
            rank = pending.index(r) if r in pending else len(pending)
            return (rank, round((t - self.now) / 1e-3))
        inflight = tuple(sorted(
            (dest, aid, p.src_server, p.source, rel(p.eta),
             p.attempt, p.stalled,
             rel(p.retry_at) if p.retry_at >= 0 else (-2, 0))
            for (dest, aid), p in s._inflight.items()))
        egress = tuple(sorted(
            (src, tuple(sorted(rel(t) for t in etas if t > self.now
                               + _EPS)))
            for src, etas in self.network._egress.items()
            if any(t > self.now + _EPS for t in etas)))
        table = tuple(sorted(
            (aid, tuple((sid, round(phi, 9)) for sid, phi in entry))
            for aid, entry in self.routing._table.items()))
        return (
            s.n_servers,
            tuple(tuple(sorted(loc)) for loc in s.local),
            tuple(tuple(sorted(hc)) for hc in s.host_cache),
            tuple(sorted((aid, tuple(sorted(v)))
                         for aid, v in s.desired.items())),
            tuple(sorted(s.draining)), tuple(sorted(s.retired)),
            tuple(sorted(s.failed)), tuple(sorted(s.lost)),
            inflight, egress, table,
            tuple(sorted(self.routing.blocked)),
        )

    def invariant_errors(self) -> List[str]:
        return check_store_invariants(self.store, self.now, self.routing,
                                      closed_world=True)

    # -- actions --------------------------------------------------------
    def enabled_actions(self) -> List[Tuple[str, Callable[["World"], None]]]:
        cfg, s = self.cfg, self.store
        acts: List[Tuple[str, Callable[["World"], None]]] = []
        live = [sid for sid in s.live_servers() if sid not in s.draining]
        for sid in live:
            for aid, _ in cfg.adapters:
                acts.append((f"access({sid},{aid})",
                             _mk_access(sid, aid)))
        for i, tmpl in enumerate(cfg.rebalance_templates):
            if all(sid < s.n_servers and sid not in s.retired
                   and sid not in s.draining
                   for entry in tmpl.values() for sid in entry):
                acts.append((f"rebalance(t{i})", _mk_rebalance(tmpl)))
        if cfg.enable_add_server and s.n_servers < cfg.max_servers:
            acts.append(("add_server", _do_add_server))
        if cfg.enable_drain:
            for sid in live:
                # keep at least one live non-draining server
                if len(live) > 1 and not s.draining:
                    acts.append((f"drain({sid})", _mk_drain(sid)))
            for sid in sorted(s.draining):
                if not s.local[sid] and not s.inflight_from(sid) \
                        and not s.inflight_to(sid):
                    acts.append((f"retire({sid})", _mk_retire(sid)))
        if cfg.enable_crash:
            for sid in live:
                if len(live) > 1:        # never crash the last server
                    acts.append((f"crash_server({sid})", _mk_crash(sid)))
            for sid in sorted(s.failed):
                acts.append((f"restore_server({sid})", _mk_restore(sid)))
        if cfg.enable_stall:
            for (dest, aid), p in sorted(s._inflight.items()):
                if p.retry_at < 0 and not p.stalled:
                    acts.append((f"fetch_timeout({dest},{aid})",
                                 _mk_stall(dest, aid)))
        if s.next_event_time(self.now) is not None:
            acts.append(("advance", _do_advance))
        return acts


class ExpectedRefusal(Exception):
    """An action the protocol legitimately refuses (no-op transition)."""


def _mk_access(sid: int, aid: str):
    def act(w: World):
        try:
            w.store.start_fetch(sid, aid, now=w.now)
        except RuntimeError as e:   # draining/retired refusal is correct
            raise ExpectedRefusal(str(e))
    return act


def _mk_rebalance(tmpl: dict):
    def act(w: World):
        w.routing.update(tmpl)
        w.store.apply_placement(tmpl, now=w.now, prefetch=True)
    return act


def _do_add_server(w: World):
    w.store.add_server()


def _mk_drain(sid: int):
    def act(w: World):
        live = [x for x in w.store.live_servers()
                if x != sid and x not in w.store.draining]
        placement: Dict[str, Dict[int, float]] = {}
        for aid, entry in w.routing._table.items():
            kept = {s: phi for s, phi in entry if s != sid}
            placement[aid] = kept or {live[0]: 1.0}
        w.routing.update(placement)
        w.store.apply_placement(placement, now=w.now)
        w.store.drain_server(sid, now=w.now)
    return act


def _mk_retire(sid: int):
    def act(w: World):
        w.store.retire_server(sid)
        w.routing.block_server(sid)
    return act


def _mk_crash(sid: int):
    """Confirmed-dead handling, mirroring ``Orchestrator.fail_server``:
    drop every copy the dead server held, re-place its adapters onto
    survivors (prefetch re-warms), then block routing — block comes
    last so renormalization never strands an empty entry."""
    def act(w: World):
        live = [x for x in w.store.live_servers() if x != sid]
        if not live:
            raise ExpectedRefusal("last live server")
        w.store.fail_server(sid, now=w.now)
        placement: Dict[str, Dict[int, float]] = {}
        for aid, entry in w.routing._table.items():
            kept = {s: phi for s, phi in entry if s != sid}
            tot = sum(kept.values())
            if kept and tot > 0:
                placement[aid] = {s: phi / tot
                                  for s, phi in kept.items()}
            else:
                placement[aid] = {live[0]: 1.0}
        w.routing.update(placement)
        w.store.apply_placement(placement, now=w.now, prefetch=True)
        w.routing.block_server(sid)
    return act


def _mk_restore(sid: int):
    def act(w: World):
        w.store.restore_server(sid)
        w.routing.unblock_server(sid)
    return act


def _mk_stall(dest: int, aid: str):
    def act(w: World):
        if not w.store.stall_transfer(dest, aid):
            raise ExpectedRefusal("no stallable transfer")
    return act


def _do_advance(w: World):
    t = w.store.next_event_time(w.now)
    if t is None:
        raise ExpectedRefusal("no pending event")
    w.now = max(w.now, t)
    w.store.poll(w.now)


def _drain_terminates(w: World, max_steps: int = 64) -> Optional[str]:
    """Liveness probe: advancing the clock alone must empty every
    draining server (enabling retirement) in finitely many steps."""
    probe = w.clone()
    for _ in range(max_steps):
        if probe.store.next_event_time(probe.now) is None:
            break
        _do_advance(probe)
    else:
        return "drain-termination: transfers still pending after " \
               f"{max_steps} clock advances"
    for sid in sorted(probe.store.draining):
        if probe.store.local[sid]:
            return (f"drain-termination: draining server {sid} still "
                    f"holds {sorted(probe.store.local[sid])} after all "
                    f"transfers landed — it can never retire")
        if probe.store.inflight_from(sid) or probe.store.inflight_to(sid):
            return (f"drain-termination: draining server {sid} still "
                    f"has transfers in flight after quiescence")
    return None


def _fetch_terminates(w: World, max_steps: int = 64) -> Optional[str]:
    """Liveness probe for the chaos plane: no fetch waits forever. From
    any state with in-flight transfers, advancing the clock alone must
    land or retry every one of them to completion — a transfer whose
    source died must fail over (backoff → alternate source / SSD), not
    hang."""
    probe = w.clone()
    for _ in range(max_steps):
        if not probe.store._inflight:
            return None
        if probe.store.next_event_time(probe.now) is None:
            break
        try:
            _do_advance(probe)
        except Exception as e:
            return (f"fetch-liveness: clock advance raised "
                    f"{type(e).__name__}: {e}")
    if probe.store._inflight:
        stuck = sorted(probe.store._inflight)
        return (f"fetch-liveness: transfers {stuck} still in flight "
                f"after {max_steps} clock advances — a fetch is "
                f"waiting forever (dead source never failed over)")
    return None


# --------------------------------------------------------------------------
# BFS search
# --------------------------------------------------------------------------


def check_model(cfg: ModelConfig,
                max_violations: int = 10) -> CheckResult:
    """Breadth-first exploration of every action interleaving up to
    ``cfg.max_depth``, deduplicating on the canonical state key."""
    root = World(cfg)
    violations: List[Violation] = []
    truncated = False

    def record(world: World, trace: Tuple[str, ...]) -> bool:
        errs = world.invariant_errors()
        if cfg.enable_drain and not errs and world.store.draining:
            live = _drain_terminates(world)
            if live:
                errs = [live]
        if (cfg.enable_crash or cfg.enable_stall) and not errs \
                and world.store._inflight:
            live = _fetch_terminates(world)
            if live:
                errs = [live]
        for e in errs:
            violations.append(Violation(e.split(":", 1)[0], e, trace))
        return bool(errs)

    seen = {root.key(): ()}
    queue = deque([(root, ())])
    transitions = 0
    record(root, ())
    while queue and len(violations) < max_violations:
        world, trace = queue.popleft()
        if len(trace) >= cfg.max_depth:
            truncated = True
            continue
        for label, act in world.enabled_actions():
            nxt = world.clone()
            try:
                act(nxt)
            except ExpectedRefusal:
                continue
            except Exception as e:   # unexpected crash is a finding
                violations.append(Violation(
                    "crash", f"{type(e).__name__}: {e}",
                    trace + (label,)))
                continue
            transitions += 1
            k = nxt.key()
            if k in seen:
                continue
            ntrace = trace + (label,)
            seen[k] = ntrace
            if record(nxt, ntrace):
                continue             # don't explore past a violation
            if len(seen) >= cfg.max_states:
                truncated = True
                queue.clear()
                break
            queue.append((nxt, ntrace))
    return CheckResult(states=len(seen), transitions=transitions,
                       violations=violations, truncated=truncated)


# --------------------------------------------------------------------------
# The small-model suite (run by `python -m repro.analysis` and CI)
# --------------------------------------------------------------------------


def fetch_gc_model(store_cls: Optional[type] = None,
                   max_depth: int = 7) -> ModelConfig:
    """The 2-server/2-adapter fetch+rebalance model (growable to 3 via
    scale-up): reaches the PR 3 GC-vs-fetch race in 4 actions when the
    ``_gc`` in-flight guard is removed — rebalance a0 onto one server,
    scale up, fetch toward the new server (sourcing the stale copy),
    then a hit on the placed server GCs the source mid-flight."""
    return ModelConfig(
        n_servers=2,
        adapters=(("a0", 64 << 20), ("a1", 64 << 20)),
        seed_placement={"a0": {0: 0.5, 1: 0.5}, "a1": {0: 1.0}},
        rebalance_templates=({"a0": {1: 1.0}, "a1": {0: 1.0}},),
        max_servers=3, enable_add_server=True, enable_drain=False,
        max_depth=max_depth, store_cls=store_cls)


def drain_retire_model(store_cls: Optional[type] = None,
                       max_depth: int = 7) -> ModelConfig:
    """2-server/2-adapter drain→retire lifecycle: every interleaving of
    accesses, a rebalance that spreads copies (creating in-flight
    transfers for drains to race with), a drain of either server, clock
    advances and the final retire + routing block."""
    return ModelConfig(
        n_servers=2,
        adapters=(("a0", 64 << 20), ("a1", 64 << 20)),
        seed_placement={"a0": {0: 1.0}, "a1": {1: 1.0}},
        rebalance_templates=({"a0": {0: 0.5, 1: 0.5},
                              "a1": {1: 1.0}},),
        max_servers=2, enable_add_server=False, enable_drain=True,
        max_depth=max_depth, store_cls=store_cls)


def crash_recovery_model(store_cls: Optional[type] = None,
                         max_depth: int = 8) -> ModelConfig:
    """2-server/2-adapter chaos model: every interleaving of accesses,
    crashes of either server (with survivor re-placement + routing
    block), restores, injected fetch stalls and clock advances. Checks
    that a confirmed-dead server never receives a route or feeds a
    transfer, that losing the last HBM copy recovers via SSD instead
    of breaching min-copy, and (fetch-liveness) that no fetch waits
    forever on a dead or stalled source — retry must fail over."""
    return ModelConfig(
        n_servers=2,
        adapters=(("a0", 64 << 20), ("a1", 64 << 20)),
        seed_placement={"a0": {0: 0.5, 1: 0.5}, "a1": {1: 1.0}},
        max_servers=2, enable_add_server=False, enable_drain=False,
        enable_crash=True, enable_stall=True, durable_ssd=True,
        max_depth=max_depth, store_cls=store_cls)


def small_model_suite() -> List[Tuple[str, CheckResult]]:
    return [
        # depths chosen past each model's BFS fixpoint: the first two
        # come back with truncated=False, i.e. the full reachable state
        # space was explored; crash-recovery's fault alphabet keeps
        # minting fresh retry states, so it is depth-bounded instead
        ("fetch-gc", check_model(fetch_gc_model(max_depth=30))),
        ("drain-retire", check_model(drain_retire_model(max_depth=14))),
        ("crash-recovery", check_model(crash_recovery_model(max_depth=8))),
    ]
