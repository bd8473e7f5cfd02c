"""Cluster orchestrator facade (paper Fig 11): owns the placement policy,
routing table, tiered adapter store, and demand estimator. The
discrete-event simulator drives it; ``launch/serve.py`` drives the same
object against real JAX engines for the end-to-end example.

The request path speaks ``FetchPlan``s: ``route_plan`` routes a request
and asks the ``AdapterStore`` how its adapter will be served — a hit, a
blocking migrate fetch (async, completing at ``plan.eta``), or a GDR
remote read from a peer while the local copy warms (``access_mode=
"remote-read"``). The legacy ``route`` keeps the old synchronous
(server_id, latency) contract on top of the same store.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .baselines import POLICIES
from .demand import DemandEstimator
from .pool import AdapterStore, FetchPlan, FetchRetryPolicy
from .routing import RoutingTable
from .types import AdapterInfo, Placement, PlacementContext


class ClusterOrchestrator:
    def __init__(self, n_servers: int, adapters: List[AdapterInfo],
                 operating_points: Dict[int, float],
                 policy: str = "loraserve", network=None, seed: int = 0,
                 access_mode: str = "migrate", prefetch: bool = False,
                 sync_store: bool = True,
                 retry: Optional["FetchRetryPolicy"] = None,
                 durable_ssd: bool = False):
        if access_mode not in ("migrate", "remote-read"):
            raise ValueError(f"unknown access_mode {access_mode!r}")
        # sync_store: legacy clock-less callers (route()/end_of_timestep
        # with the default now=0.0) have no event loop to drive
        # store.poll(); prefetch warms then complete synchronously so
        # transfers cannot strand on links or pin GC. Async drivers
        # (LoRAServeCluster) pass sync_store=False and poll themselves.
        self.sync_store = sync_store
        self.n = n_servers
        self.adapters = adapters
        self.meta = {a.adapter_id: a for a in adapters}
        self.operating_points = operating_points
        self.policy = POLICIES[policy]() if isinstance(policy, str) \
            else policy
        self.access_mode = access_mode
        self.prefetch = prefetch
        self.demand = DemandEstimator()
        # fleet lifecycle (controlplane scale/drain): ids are stable,
        # placement is solved over active-minus-draining only
        self.active: List[int] = list(range(n_servers))
        self.draining: set = set()
        # adapter lifecycle: ids mid loss-free retire — routing entries
        # already gone, copies leave once the host signals quiescence
        self.retiring: set = set()
        ctx = PlacementContext(
            n_servers=n_servers, adapters=adapters,
            demand_tps={a.adapter_id: 1.0 for a in adapters},
            operating_points=operating_points)
        self.placement: Placement = self.policy.place(ctx)
        self.router = RoutingTable(self.placement, seed=seed)
        # one AdapterStore; `pool` kept as the legacy name
        self.store = self.pool = AdapterStore(n_servers, adapters,
                                              network, retry=retry,
                                              durable_ssd=durable_ssd,
                                              retry_seed=seed)
        self.store.seed(self.placement)
        self._window_tokens: Dict[str, float] = {}

    # -- request path (Fig 11 steps 1-4) ----------------------------------
    def route_plan(self, adapter_id: str, tokens: float = 0.0,
                   now: float = 0.0) -> Tuple[int, FetchPlan]:
        """Route a request and plan its adapter's data path. Returns
        (server_id, FetchPlan); the plan is a hit, an async migrate
        fetch, or a remote-read serve depending on residency and the
        configured access mode."""
        sid, entry = self.router.route_detailed(adapter_id, tokens)
        # remote reads prefer peers the adapter is *placed* on
        plan = self.store.plan_access(sid, adapter_id, now=now,
                                      access_mode=self.access_mode,
                                      preferred_peers=[s for s, _ in
                                                       entry])
        if self.sync_store:
            # no event loop will poll(): complete the transfer now so
            # it cannot strand on links or pin GC; the plan still
            # carries the modeled latency/ETA for accounting
            self.store.finish(plan)
        self._window_tokens[adapter_id] = \
            self._window_tokens.get(adapter_id, 0.0) + tokens
        return sid, plan

    def route(self, adapter_id: str, tokens: float = 0.0,
              now: float = 0.0):
        """Legacy synchronous path: returns (server_id,
        fetch_latency_seconds); the fetch completes instantly. Callers
        combining this path with ``prefetch=True`` should pass their
        clock as ``now`` so background prefetch transfers (completed by
        ``ensure_local``'s internal poll) land and release their
        links."""
        sid = self.router.route(adapter_id, tokens)
        lat, _ = self.store.ensure_local(sid, adapter_id, now=now)
        self._window_tokens[adapter_id] = \
            self._window_tokens.get(adapter_id, 0.0) + tokens
        return sid, lat

    # -- control path (Fig 11 steps 6-7) -----------------------------------
    def placeable_servers(self) -> List[int]:
        return [s for s in self.active if s not in self.draining]

    def end_of_timestep(self, period_s: float,
                        now: float = 0.0) -> Placement:
        for aid in self.meta:
            self.demand.observe(aid, self._window_tokens.get(aid, 0.0)
                                / period_s)
        self._window_tokens = {}
        if self.policy.dynamic:
            self._resolve(now)
        return self.placement

    def _resolve(self, now: float) -> List[FetchPlan]:
        """Re-solve placement over the placeable fleet and push it into
        the routing table + store. Returns any started prefetch plans
        (already completed when ``sync_store``)."""
        ids = self.placeable_servers()
        ctx = PlacementContext(
            n_servers=len(ids), adapters=self.adapters,
            demand_tps=self.demand.demands(list(self.meta)),
            operating_points=self.operating_points,
            prev_placement=self.placement, server_ids=ids)
        self.placement = self.policy.place(ctx)
        self.router.update(self.placement)
        plans = self.store.apply_placement(self.placement, now=now,
                                           prefetch=self.prefetch)
        if self.sync_store:
            for p in plans:
                self.store.finish(p)
        return plans

    # -- adapter lifecycle (runtime register / loss-free retire) -----------
    def register_adapter(self, info: AdapterInfo, now: float = 0.0,
                         server: Optional[int] = None) -> int:
        """Make a new adapter servable mid-run. Its first copy lands on
        ``server`` (default: the placeable server holding the fewest
        adapters) with a single full-phi route; the next
        ``end_of_timestep`` folds it into the demand-driven placement
        like any other adapter. Returns the chosen server id."""
        aid = info.adapter_id
        if aid in self.meta:
            raise ValueError(f"adapter {aid!r} already registered")
        if server is None:
            server = min(self.placeable_servers(),
                         key=lambda s: (self.store.server_adapter_count(s),
                                        s))
        elif server not in self.placeable_servers():
            raise RuntimeError(f"register of {aid!r} on non-placeable "
                               f"server {server}")
        self.adapters.append(info)
        self.meta[aid] = info
        self.placement[aid] = {server: 1.0}
        self.router.update(self.placement)
        self.store.register_adapter(info, server)
        return server

    def begin_retire_adapter(self, adapter_id: str) -> None:
        """Start a loss-free adapter retire: routing stops now (new
        routes raise ``UnknownAdapterError``), placement forgets it, the
        store keeps its copies readable until ``finish_retire_adapter``.
        In-flight requests referencing it are unaffected."""
        if adapter_id not in self.meta:
            raise KeyError(adapter_id)
        self.retiring.add(adapter_id)
        self.adapters[:] = [a for a in self.adapters
                            if a.adapter_id != adapter_id]
        self.meta.pop(adapter_id, None)
        self.placement.pop(adapter_id, None)
        self.router.remove_adapter(adapter_id)
        # popping `desired` freezes GC for this adapter: its copies
        # survive (readable by in-flight work) until deregistration
        self.store.desired.pop(adapter_id, None)
        self._window_tokens.pop(adapter_id, None)

    def finish_retire_adapter(self, adapter_id: str) -> None:
        """Complete a retire once the host observes quiescence (no live
        requests, no transfers): purge every copy from every tier."""
        self.store.deregister_adapter(adapter_id)
        self.retiring.discard(adapter_id)

    # -- fleet lifecycle (controlplane scale-up / drain / retire) ----------
    def add_server(self, now: float = 0.0) -> int:
        """Provision one server and fold it into a fresh placement.
        Returns the new (stable) server id."""
        sid = self.store.add_server()
        self.n = self.store.n_servers
        self.active.append(sid)
        self._resolve(now)
        return sid

    def begin_drain(self, server_id: int,
                    now: float = 0.0) -> List[FetchPlan]:
        """Take ``server_id`` out of placement and routing, then migrate
        its holdings to the survivors through the store. Returns the
        in-flight migration plans (the caller turns their ETAs into
        fetch events; empty when ``sync_store`` completed them)."""
        if server_id in self.draining:
            return []
        self.draining.add(server_id)
        self._resolve(now)
        plans = self.store.drain_server(server_id, now=now)
        if self.sync_store:
            for p in plans:
                self.store.finish(p)
            return []
        return plans

    def drain_complete(self, server_id: int) -> bool:
        """Whether the store side of a drain has finished: no copies
        left on the server and no transfers touching it. (The host also
        checks its backend for still-running requests.)"""
        return (self.store.server_adapter_count(server_id) == 0
                and self.store.inflight_from(server_id) == 0
                and self.store.inflight_to(server_id) == 0)

    def retire_server(self, server_id: int) -> None:
        self.store.retire_server(server_id)
        self.router.block_server(server_id)
        self.draining.discard(server_id)
        self.active.remove(server_id)

    # -- fault plane (repro.faults crash -> recover -> restore) ------------
    def fail_server(self, server_id: int,
                    now: float = 0.0) -> List[FetchPlan]:
        """Crash-triggered recovery, ordered so every intermediate state
        is consistent: (1) the store drops the dead server's copies and
        re-sources its transfers, (2) placement re-solves over the
        survivors and the routing table updates (entries no longer
        reference the dead server), (3) the server is blocked so a stale
        route raises instead of dispatching. Orphaned adapters re-warm
        via prefetch onto survivors (from host cache, a surviving peer,
        or the durable SSD tier). Returns the recovery fetch plans."""
        if server_id in self.draining:
            self.draining.discard(server_id)
        if server_id not in self.active:
            raise RuntimeError(f"crash of unknown/retired server "
                               f"{server_id}")
        self.store.fail_server(server_id, now=now)
        self.active.remove(server_id)
        prefetch, self.prefetch = self.prefetch, True
        try:
            plans = self._resolve(now)
        finally:
            self.prefetch = prefetch
        self.router.block_server(server_id)
        return plans

    def restore_server(self, server_id: int, now: float = 0.0) -> None:
        """Bring a crashed server back (empty): unblock routing, rejoin
        the active fleet, and re-solve placement so copies re-warm onto
        it."""
        if server_id in self.active:
            return
        self.store.restore_server(server_id)
        self.router.unblock_server(server_id)
        self.active.append(server_id)
        self.active.sort()
        self._resolve(now)
