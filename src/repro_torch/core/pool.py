"""Tiered adapter data plane (paper §IV-B, Fig 13/14).

``AdapterStore`` replaces the old synchronous ``DistributedAdapterPool``
API: adapter movement is a first-class subsystem with per-server tiers,
explicit ``FetchPlan``s, and asynchronous in-flight transfers that
occupy link bandwidth on the simulator clock.

Tiers, per server:

* **hbm** — the adapter sits in the server's bank slot and is servable
  (``local`` / ``index`` track this tier; the cluster invariant "every
  adapter lives on >= 1 server" is over HBM copies);
* **host** — a bounded LRU host-memory cache holding copies recently
  demoted from HBM (delete-after-copy GC demotes instead of dropping),
  refetchable over PCIe at ``local_host`` cost;
* **peer** — any other server's HBM copy, readable over the fabric
  (GPUDirect RDMA / ICI);
* **ssd** — a cluster-wide spill source (the paper's prohibitively
  slow one) offered as an alternative when every other link is
  congested; it is never a correctness backstop — an adapter with no
  HBM or host copy left raises instead of silently serving from SSD.

Data path: ``start_fetch`` picks the cheapest source *by modeled
latency under current link load* (replacing ``src = min(holders)``),
registers an in-flight transfer, and returns a ``FetchPlan`` whose
``eta`` the caller turns into a fetch-completion event; ``poll``
installs finished copies. Duplicate in-flight fetches of one adapter to
one server coalesce onto the first transfer. ``start_remote_read``
serves a miss from a peer's copy over GDR (per-iteration penalty from
``NetworkModel``) while the local copy warms in the background, and
``apply_placement(prefetch=True)`` proactively warms newly-placed
copies instead of migrating lazily on first hit.

GC (the Fig-13 delete-after-copy step) skips adapters with transfers in
flight: a peer copy being read by an in-flight fetch must survive until
that transfer lands.
"""
from __future__ import annotations

import dataclasses
import math
import os
import random
from typing import Dict, List, Optional, Set, Tuple

from .types import AdapterInfo, Placement

# opt-in runtime validation: with REPRO_CHECK_INVARIANTS=1 the store
# re-checks the model checker's invariants (repro.analysis.protocol)
# after every poll/fetch, so sim runs validate what the checker proves
# exhaustively on small models
CHECK_INVARIANTS_ENV = "REPRO_CHECK_INVARIANTS"


def runtime_checks_enabled() -> bool:
    return os.environ.get(CHECK_INVARIANTS_ENV, "") not in ("", "0")

TIER_HBM = "hbm"
TIER_HOST = "host"
TIER_PEER = "peer"
TIER_SSD = "ssd"

_INF = float("inf")


@dataclasses.dataclass(frozen=True)
class FetchRetryPolicy:
    """Timeout/retry knobs for in-flight transfers (repro.faults).

    A healthy transfer lands exactly at its modeled ETA, so the
    per-attempt deadline is ``eta + timeout`` — it only fires when the
    transfer was stalled or its source died. Retries back off
    exponentially with multiplicative jitter (seeded, deterministic)
    and re-pick the cheapest *surviving* source, so a dead GDR peer
    falls back to host cache or the SSD tier."""
    timeout: float = 0.25        # grace beyond the modeled ETA (s)
    base_backoff: float = 0.02   # first retry delay (s)
    max_backoff: float = 1.0     # backoff cap (s)
    jitter: float = 0.25         # multiplicative jitter fraction
    max_attempts: int = 12       # loud failure past this many retries

    def backoff(self, attempt: int, rng: random.Random) -> float:
        base = min(self.max_backoff, self.base_backoff * (2 ** attempt))
        return base * (1.0 + self.jitter * rng.random())


class CircuitBreaker:
    """Per-peer fetch-source breaker: closed -> open after
    ``threshold`` consecutive failures, half-open after ``cooldown``
    seconds (one probe transfer allowed), closed again on success."""

    def __init__(self, threshold: int = 3, cooldown: float = 1.0):
        self.threshold = threshold
        self.cooldown = cooldown
        self.state = "closed"
        self.failures = 0
        self.open_until = -_INF
        self.opens = 0

    def allows(self, now: float) -> bool:
        if self.state == "open":
            if now + 1e-12 >= self.open_until:
                self.state = "half-open"
            else:
                return False
        return True

    def record_failure(self, now: float) -> None:
        self.failures += 1
        if self.state == "half-open" or self.failures >= self.threshold:
            self.state = "open"
            self.open_until = now + self.cooldown
            self.failures = 0
            self.opens += 1

    def record_success(self) -> None:
        self.state = "closed"
        self.failures = 0


@dataclasses.dataclass
class FetchPlan:
    """One planned (or in-flight, or completed) adapter movement."""
    adapter_id: str
    dest: int
    mode: str = "migrate"        # migrate | remote-read | prefetch
    hit: bool = False            # already in the dest's HBM tier
    source: str = TIER_HBM       # hbm | local_host | ib_gdr | ici | ssd
    src_server: int = -1         # peer the bytes come from (-1: host/ssd)
    nbytes: int = 0
    latency: float = 0.0         # modeled transfer time (seconds)
    eta: float = 0.0             # completion time on the caller's clock
    token_penalty: float = 0.0   # per-iteration remote-read surcharge
    read_peer: int = -1          # peer serving remote reads (remote-read)
    coalesced: bool = False      # joined an already-in-flight transfer
    # retry state (repro.faults): a transfer that blows its deadline or
    # loses its source backs off, then relaunches from a new source
    started: float = 0.0         # when the current attempt started
    deadline: float = _INF       # current attempt must land by this
    link_eta: float = 0.0        # eta registered with the network link
    attempt: int = 0             # completed (failed) attempts so far
    retry_at: float = -1.0       # >= 0: waiting out backoff until this
    stalled: bool = False        # an injector froze this transfer

    @property
    def blocking(self) -> bool:
        """Whether the request must wait for the ETA before prefill."""
        return not self.hit and self.mode != "remote-read"


class AdapterStore:
    def __init__(self, n_servers: int, adapters: List[AdapterInfo],
                 network=None, *, host_cache_bytes: int = 512 << 20,
                 ssd_spill: bool = True,
                 retry: Optional[FetchRetryPolicy] = None,
                 durable_ssd: bool = False,
                 breaker_threshold: int = 3,
                 breaker_cooldown: float = 1.0,
                 retry_seed: int = 0):
        self.n_servers = n_servers
        self.meta: Dict[str, AdapterInfo] = {a.adapter_id: a
                                             for a in adapters}
        # hbm tier: servable copies; the invariant is over these
        self.local: List[Set[str]] = [set() for _ in range(n_servers)]
        self.index: Dict[str, Set[int]] = {a.adapter_id: set()
                                           for a in adapters}
        # host tier: LRU cache of demoted copies (aid -> nbytes)
        self.host_cache: List[Dict[str, int]] = [dict()
                                                 for _ in range(n_servers)]
        self.host_cache_bytes = host_cache_bytes
        self.ssd_spill = ssd_spill
        self.network = network
        self.desired: Dict[str, Set[int]] = {}
        self._inflight: Dict[Tuple[int, str], FetchPlan] = {}
        # autoscaling lifecycle: draining servers accept no new copies
        # (their holdings are being migrated out); retired servers are
        # out of the cluster entirely, ids never reused
        self.draining: Set[int] = set()
        self.retired: Set[int] = set()
        # fault plane (repro.faults): crashed servers lose every copy
        # instantly; ``lost`` tracks adapters whose last HBM/host copy
        # died and are recoverable only from the durable SSD tier
        self.failed: Set[int] = set()
        self.lost: Set[str] = set()
        self.retry = retry or FetchRetryPolicy()
        self.durable_ssd = durable_ssd
        self.breaker_threshold = breaker_threshold
        self.breaker_cooldown = breaker_cooldown
        self.breakers: Dict[int, CircuitBreaker] = {}
        self._rng = random.Random(retry_seed)
        # telemetry
        self.fetches = 0
        self.fetch_bytes = 0
        self.evictions = 0
        self.remote_reads = 0
        self.prefetches = 0
        self.coalesced = 0
        self.host_hits = 0
        self.ssd_fetches = 0
        self.drain_fetches = 0
        self.fetch_retries = 0
        self.fetch_timeouts = 0
        self.ssd_recoveries = 0
        # obs.Tracer (host-attached): every started transfer emits a
        # "transfer" span on the store track, start -> modeled ETA
        self.tracer = None

    # -- initial seeding -----------------------------------------------
    def seed(self, placement: Placement) -> None:
        for aid, entry in placement.items():
            for sid in entry:
                self.local[sid].add(aid)
                self.index[aid].add(sid)
        self.desired = {aid: set(entry) for aid, entry in placement.items()}

    # -- tier introspection ----------------------------------------------
    def tier(self, server_id: int, adapter_id: str) -> Optional[str]:
        if adapter_id in self.local[server_id]:
            return TIER_HBM
        if adapter_id in self.host_cache[server_id]:
            return TIER_HOST
        return None

    def inflight_count(self, adapter_id: Optional[str] = None) -> int:
        if adapter_id is None:
            return len(self._inflight)
        return sum(1 for (_, aid) in self._inflight if aid == adapter_id)

    def inflight_to(self, server_id: int) -> int:
        return sum(1 for (sid, _) in self._inflight if sid == server_id)

    def inflight_from(self, server_id: int) -> int:
        """Transfers currently reading bytes out of ``server_id`` — a
        draining server cannot retire while it is still a source."""
        return sum(1 for p in self._inflight.values()
                   if p.src_server == server_id)

    # -- adapter lifecycle (runtime register / deregister) -----------------
    def register_adapter(self, info: AdapterInfo, server_id: int) -> None:
        """Install a newly-registered adapter's first copy directly in
        ``server_id``'s HBM tier (the registration upload, not a fetch —
        the fetch counters stay miss-driven). The caller has already
        placed it there."""
        aid = info.adapter_id
        if aid in self.meta:
            raise ValueError(f"adapter {aid!r} already registered")
        if server_id in self.retired:
            raise RuntimeError(f"register of {aid!r} on retired "
                               f"server {server_id}")
        if server_id in self.draining:
            raise RuntimeError(f"register of {aid!r} on draining "
                               f"server {server_id}")
        self.meta[aid] = info
        self.index[aid] = {server_id}
        self.local[server_id].add(aid)
        self.desired.setdefault(aid, set()).add(server_id)
        self._debug_check()

    def deregister_adapter(self, adapter_id: str) -> None:
        """Remove every copy of a retired adapter from every tier. The
        caller guarantees quiescence (no live requests, no transfers in
        flight); loud otherwise — dropping an adapter mid-transfer would
        strand its bytes on a link."""
        if adapter_id not in self.meta:
            raise KeyError(adapter_id)
        if self.inflight_count(adapter_id):
            raise RuntimeError(f"deregister of {adapter_id!r} with "
                               f"transfers in flight")
        for sid in range(self.n_servers):
            self.local[sid].discard(adapter_id)
            self.host_cache[sid].pop(adapter_id, None)
        self.index.pop(adapter_id, None)
        self.desired.pop(adapter_id, None)
        self.meta.pop(adapter_id)

    # -- fleet lifecycle (controlplane scale-up / drain / retire) ---------
    def add_server(self) -> int:
        """Provision one empty server; returns its (stable, new) id."""
        sid = self.n_servers
        self.n_servers += 1
        self.local.append(set())
        self.host_cache.append(dict())
        return sid

    def begin_drain(self, server_id: int) -> None:
        """Stop placing new copies on ``server_id``; its existing copies
        stay readable (as fetch sources and remote-read peers) until the
        migration out completes."""
        self.draining.add(server_id)

    def drain_server(self, server_id: int, now: float = 0.0
                     ) -> List[FetchPlan]:
        """Migrate everything off ``server_id``: for each adapter it
        holds, start fetches toward its desired servers (the caller has
        already re-placed without this server) and GC copies that are
        already redundant. Returns the started plans; the server is
        empty once they land and ``poll`` has GC'd it."""
        self.begin_drain(server_id)
        plans: List[FetchPlan] = []
        for aid in sorted(self.local[server_id]):
            dests = self.desired.get(aid, set()) - {server_id}
            if not dests:
                raise RuntimeError(
                    f"drain of server {server_id} before re-placement: "
                    f"adapter {aid!r} has nowhere to go")
            for d in sorted(dests):
                if aid not in self.local[d]:
                    p = self.start_fetch(d, aid, now=now, mode="drain")
                    if not p.hit and not p.coalesced:
                        plans.append(p)
            self._gc(aid)   # no-op while the migration is in flight
        return plans

    def retire_server(self, server_id: int) -> None:
        """Remove an emptied, drained server from the cluster. Loud if
        it still holds copies or feeds in-flight transfers."""
        if self.local[server_id]:
            raise RuntimeError(
                f"retire of server {server_id} with "
                f"{len(self.local[server_id])} HBM copies still resident")
        if self.inflight_from(server_id) or self.inflight_to(server_id):
            raise RuntimeError(
                f"retire of server {server_id} with transfers in flight")
        self.host_cache[server_id].clear()
        self.draining.discard(server_id)
        self.retired.add(server_id)

    def live_servers(self) -> List[int]:
        return [s for s in range(self.n_servers)
                if s not in self.retired and s not in self.failed]

    # -- fault plane (repro.faults) ---------------------------------------
    def fail_server(self, server_id: int, now: float = 0.0) -> List[str]:
        """Crash ``server_id``: every tier it holds vanishes, transfers
        into it are cancelled (link slots released), and transfers
        sourcing from it lose their source and enter the retry path.
        Returns the adapters whose *last* HBM/host copy just died —
        recoverable from SSD when the store is ``durable_ssd``, lost
        (loud on next access) otherwise."""
        if server_id in self.retired:
            raise RuntimeError(f"crash of retired server {server_id}")
        if server_id in self.failed:
            return []
        self.failed.add(server_id)
        orphans: List[str] = []
        for aid in sorted(self.local[server_id]):
            self.local[server_id].discard(aid)
            self.index[aid].discard(server_id)
            if not self.index[aid]:
                orphans.append(aid)
        self.host_cache[server_id].clear()
        cancelled: List[str] = []
        for key in sorted(self._inflight):
            dest, aid = key
            p = self._inflight[key]
            if dest == server_id:
                if self.network is not None and p.src_server >= 0:
                    self.network.end_transfer(p.src_server, p.link_eta)
                del self._inflight[key]
                cancelled.append(aid)
            elif p.src_server == server_id and p.retry_at < 0:
                self._fail_attempt(p, now)
        for aid in orphans + cancelled:
            # an in-flight copy may still land elsewhere; only a truly
            # copy-less adapter is "lost" (awaiting SSD recovery) — a
            # cancelled inbound fetch counts when it was the sole copy
            # in motion for an already-orphaned adapter
            if not self.index.get(aid) and not self.inflight_count(aid) \
                    and not any(aid in hc for hc in self.host_cache):
                self.lost.add(aid)
        self._debug_check(now)
        return orphans

    def restore_server(self, server_id: int) -> None:
        """Bring a crashed server back, empty: it rejoins the fleet as
        a valid fetch destination; copies re-warm via placement."""
        self.failed.discard(server_id)

    def stall_transfer(self, dest: int, adapter_id: str,
                       extra: float = _INF) -> bool:
        """Fault injection: freeze (or slow by ``extra`` seconds) the
        in-flight transfer of ``adapter_id`` to ``dest``. The link slot
        is re-timed to match, so occupancy accounting stays exact; the
        attempt's deadline is *not* moved, so the retry path fires."""
        p = self._inflight.get((dest, adapter_id))
        if p is None or p.retry_at >= 0:
            return False
        new_eta = p.eta + extra
        if self.network is not None and p.src_server >= 0:
            self.network.move_transfer(p.src_server, p.link_eta, new_eta)
        p.eta = new_eta
        p.link_eta = new_eta
        p.stalled = True
        return True

    def _fail_attempt(self, p: FetchPlan, now: float) -> None:
        """One attempt timed out (or its source died): release the link
        slot, charge the source's breaker, and back off before
        re-picking a source. Loud past ``retry.max_attempts``."""
        if self.network is not None and p.src_server >= 0:
            self.network.end_transfer(p.src_server, p.link_eta)
            self._breaker(p.src_server).record_failure(now)
        self.fetch_timeouts += 1
        p.attempt += 1
        if p.attempt >= self.retry.max_attempts:
            raise RuntimeError(
                f"fetch of {p.adapter_id!r} to server {p.dest} failed "
                f"{p.attempt} attempts (last source {p.source!r} from "
                f"server {p.src_server})")
        p.retry_at = now + self.retry.backoff(p.attempt - 1, self._rng)
        p.src_server = -1
        p.source = "retry-wait"
        p.eta = _INF
        p.deadline = _INF
        p.stalled = False

    def _relaunch(self, p: FetchPlan, now: float) -> None:
        """Backoff elapsed: re-pick the cheapest surviving source and
        restart the transfer (same plan object — coalesced waiters keep
        observing it through the in-flight table)."""
        source, src_server, _ = self._pick_source(p.dest, p.adapter_id,
                                                  now)
        if self.network is None:
            latency, eta = 0.0, now
        else:
            latency, eta = self.network.begin_transfer(
                p.nbytes, source, now=now,
                src_server=src_server if src_server >= 0 else None)
        p.source = source
        p.src_server = src_server
        p.latency = latency
        p.eta = eta
        p.link_eta = eta
        p.started = now
        p.deadline = eta + self.retry.timeout
        p.retry_at = -1.0
        self.fetch_retries += 1
        if source == "ssd":
            self.ssd_fetches += 1
        elif source == "local_host":
            self.host_hits += 1
        if self.tracer is not None:
            self.tracer.record(
                "transfer-retry", now, eta, cat="transfer", track="store",
                attrs={"adapter_id": p.adapter_id, "mode": p.mode,
                       "source": source, "src_server": src_server,
                       "dest": p.dest, "attempt": p.attempt})

    # -- placement updates (Fig 13; now with optional prefetch) ----------
    def apply_placement(self, placement: Placement, now: float = 0.0,
                        prefetch: bool = False) -> List[FetchPlan]:
        """Record the new desired placement. Default is lazy migration
        (adapters move on first access, stale copies GC'd then); with
        ``prefetch=True`` newly-placed copies start warming immediately,
        highest-phi routes first (link occupancy makes order matter).
        Returns the prefetch plans started (empty when lazy)."""
        self.desired = {aid: set(entry) for aid, entry in placement.items()}
        if not prefetch:
            return []
        todo = sorted(((phi, aid, sid)
                       for aid, entry in placement.items()
                       for sid, phi in entry.items()
                       if aid not in self.local[sid]),
                      key=lambda t: (-t[0], t[1], t[2]))
        plans = []
        for _, aid, sid in todo:
            p = self.start_fetch(sid, aid, now=now, mode="prefetch")
            if not p.hit:
                plans.append(p)
        return plans

    # -- source selection -------------------------------------------------
    def _quote(self, nbytes: int, source: str, now: float,
               src_server: Optional[int] = None) -> float:
        if self.network is None:
            return 0.0
        return self.network.plan_latency(nbytes, source, now, src_server)

    def _breaker(self, peer: int) -> CircuitBreaker:
        br = self.breakers.get(peer)
        if br is None:
            br = CircuitBreaker(self.breaker_threshold,
                                self.breaker_cooldown)
            self.breakers[peer] = br
        return br

    def _pick_source(self, dest: int, adapter_id: str, now: float
                     ) -> Tuple[str, int, float]:
        """Cheapest source under current link load: host cache beats an
        idle peer link, a loaded peer link can lose to another peer (or
        even SSD), replacing the old hardcoded ``min(holders)``.

        Fault-aware: crashed peers, downed links, and peers whose
        circuit breaker is open are never quoted. When every peer is
        excluded by a breaker — or the adapter's last copy died and the
        SSD tier is durable — the fetch falls back to SSD."""
        nbytes = self.meta[adapter_id].nbytes
        fabric = self.network.fabric if self.network else "ib_gdr"
        cands: List[Tuple[float, int, str, int]] = []
        if adapter_id in self.host_cache[dest]:
            cands.append((self._quote(nbytes, "local_host", now),
                          0, "local_host", -1))
        excluded = 0
        for p in sorted(self.index[adapter_id] - {dest}):
            if p in self.failed:
                continue
            if self.network is not None and not self.network.link_up(p):
                excluded += 1
                continue
            if p in self.breakers and not self.breakers[p].allows(now):
                excluded += 1
                continue
            lat = self._quote(nbytes, fabric, now, p)
            if math.isinf(lat):
                excluded += 1
                continue
            cands.append((lat, 1 + p, fabric, p))
        if not cands:
            # the SSD tier is a congestion alternative, never a silent
            # correctness backstop: it serves a copy-less fetch only
            # when peers exist but are fault-excluded, or when the
            # store was built durable_ssd (crash recovery); losing the
            # last copy otherwise stays loud
            if self.ssd_spill and (excluded or self.durable_ssd):
                if not self.index[adapter_id]:
                    self.ssd_recoveries += 1
                return "ssd", -1, self._quote(nbytes, "ssd", now)
            raise KeyError(f"adapter {adapter_id} lost from cluster")
        if self.ssd_spill:
            cands.append((self._quote(nbytes, "ssd", now),
                          1_000_000, "ssd", -1))
        lat, _, source, src = min(cands)
        return source, src, lat

    # -- async data path --------------------------------------------------
    def start_fetch(self, server_id: int, adapter_id: str,
                    now: float = 0.0, mode: str = "migrate") -> FetchPlan:
        """Plan and start moving ``adapter_id`` to ``server_id``. Hits
        return immediately; duplicate in-flight fetches coalesce onto
        the existing transfer (same ETA, no extra link traffic)."""
        if adapter_id in self.local[server_id]:
            self._gc(adapter_id)
            return FetchPlan(adapter_id, server_id, mode=mode, hit=True,
                             eta=now)
        if server_id in self.retired:
            raise RuntimeError(f"fetch of {adapter_id!r} to retired "
                               f"server {server_id}")
        if server_id in self.failed:
            raise RuntimeError(f"fetch of {adapter_id!r} to failed "
                               f"server {server_id}")
        if server_id in self.draining:
            raise RuntimeError(f"fetch of {adapter_id!r} to draining "
                               f"server {server_id}")
        key = (server_id, adapter_id)
        if key in self._inflight:
            self.coalesced += 1
            return dataclasses.replace(self._inflight[key], mode=mode,
                                       coalesced=True)
        nbytes = self.meta[adapter_id].nbytes
        source, src_server, _ = self._pick_source(server_id, adapter_id,
                                                  now)
        if self.network is None:
            latency, eta = 0.0, now
        else:
            latency, eta = self.network.begin_transfer(
                nbytes, source, now=now,
                src_server=src_server if src_server >= 0 else None)
        plan = FetchPlan(adapter_id, server_id, mode=mode, source=source,
                         src_server=src_server, nbytes=nbytes,
                         latency=latency, eta=eta, started=now,
                         deadline=eta + self.retry.timeout, link_eta=eta)
        self._inflight[key] = plan
        if self.tracer is not None:
            self.tracer.record(
                "transfer", now, eta, cat="transfer", track="store",
                attrs={"adapter_id": adapter_id, "mode": mode,
                       "source": source, "src_server": src_server,
                       "dest": server_id, "nbytes": nbytes})
        # `fetches`/`fetch_bytes` stay miss-driven (their pre-data-plane
        # meaning) so they compare across access modes; proactive warms
        # and drain migrations are counted separately
        if mode == "prefetch":
            self.prefetches += 1
        elif mode == "drain":
            self.drain_fetches += 1
        else:
            self.fetches += 1
            self.fetch_bytes += nbytes
        if source == "local_host":
            self.host_hits += 1
        elif source == "ssd":
            self.ssd_fetches += 1
        self._debug_check(now)
        return plan

    def plan_access(self, server_id: int, adapter_id: str,
                    now: float = 0.0, access_mode: str = "migrate",
                    preferred_peers: Optional[List[int]] = None
                    ) -> FetchPlan:
        """The data-plane decision tree, shared by every substrate:
        remote-read when configured and a peer can serve it, otherwise a
        (possibly blocking) migrate fetch."""
        if access_mode == "remote-read":
            plan = self.start_remote_read(server_id, adapter_id, now=now,
                                          preferred_peers=preferred_peers)
            if plan is not None:
                return plan
        return self.start_fetch(server_id, adapter_id, now=now)

    def start_remote_read(self, server_id: int, adapter_id: str,
                          now: float = 0.0,
                          preferred_peers: Optional[List[int]] = None
                          ) -> Optional[FetchPlan]:
        """Serve a miss by reading the adapter from a peer's HBM copy
        over the fabric while the local copy warms in the background.
        The returned plan is non-blocking: ``token_penalty`` is the
        per-iteration surcharge until ``eta`` (warm-fetch completion).
        Returns None when no peer holds a copy (caller falls back to a
        blocking migrate fetch)."""
        if adapter_id in self.local[server_id]:
            self._gc(adapter_id)
            return FetchPlan(adapter_id, server_id, mode="remote-read",
                             hit=True, eta=now)
        holders = sorted(
            p for p in self.index[adapter_id] - {server_id}
            if p not in self.failed
            and (self.network is None or self.network.link_up(p)))
        if not holders:
            return None
        prefs = [p for p in (preferred_peers or []) if p in holders]
        pool = prefs or holders
        if self.network is not None:
            peer = min(pool, key=lambda p: (self.network.link_load(p, now),
                                            p))
            penalty = self.network.remote_read_penalty(
                self.meta[adapter_id].nbytes)
        else:
            peer, penalty = pool[0], 0.0
        warm = self.start_fetch(server_id, adapter_id, now=now,
                                mode="remote-read")
        self.remote_reads += 1
        return dataclasses.replace(warm, mode="remote-read",
                                   token_penalty=penalty, read_peer=peer)

    def _complete(self, plan: FetchPlan) -> None:
        """Install a finished transfer: HBM copy at the destination,
        source link released, host-cache copy superseded."""
        del self._inflight[(plan.dest, plan.adapter_id)]
        if self.network is not None and plan.src_server >= 0:
            self.network.end_transfer(plan.src_server, plan.link_eta)
        if plan.src_server >= 0 and plan.src_server in self.breakers:
            self.breakers[plan.src_server].record_success()
        self.local[plan.dest].add(plan.adapter_id)
        self.index[plan.adapter_id].add(plan.dest)
        self.host_cache[plan.dest].pop(plan.adapter_id, None)
        self.lost.discard(plan.adapter_id)

    def poll(self, now: float) -> List[FetchPlan]:
        """Complete transfers whose ETA has passed: install the copy in
        the destination's HBM tier, release the source link, and run the
        (now unpinned) delete-after-copy GC. The fault path runs here
        too: transfers past their per-attempt deadline (or whose source
        died) release the link and back off; transfers whose backoff
        elapsed relaunch from the cheapest surviving source."""
        eps = 1e-12
        done: List[FetchPlan] = []
        for p in sorted(self._inflight.values(),
                        key=lambda q: (q.dest, q.adapter_id)):
            if p.retry_at >= 0.0:
                if p.retry_at <= now + eps:
                    self._relaunch(p, now)
                continue
            src_dead = p.src_server >= 0 and p.src_server in self.failed
            if not src_dead and p.eta <= now + eps:
                done.append(p)
            elif src_dead or p.deadline <= now + eps:
                self._fail_attempt(p, now)
        for p in done:
            self._complete(p)
        for p in done:
            self._gc(p.adapter_id)
        self._debug_check(now)
        return done

    def finish(self, plan: FetchPlan) -> None:
        """Synchronously complete one in-flight transfer ahead of its
        ETA (for clock-less legacy callers); no-op if already done."""
        key = (plan.dest, plan.adapter_id)
        if key in self._inflight:
            self._complete(self._inflight[key])
            self._gc(plan.adapter_id)

    def next_event_time(self, now: float = 0.0) -> Optional[float]:
        """Earliest future time a transfer can make progress — landing
        at its ETA, blowing its deadline, or retrying after backoff.
        Overdue (not yet polled) transfers report ``now``."""
        if not self._inflight:
            return None
        times = []
        for p in self._inflight.values():
            if p.retry_at >= 0.0:
                times.append(p.retry_at)
            else:
                times.append(min(p.eta, p.deadline))
        t = min(times)
        if math.isinf(t):
            return None
        return max(t, now)

    # -- sync compatibility shim ------------------------------------------
    def ensure_local(self, server_id: int, adapter_id: str,
                     now: float = 0.0) -> Tuple[float, int]:
        """Legacy synchronous path: start the fetch and complete *that
        transfer* immediately (other in-flight transfers keep their
        ETAs; whatever is genuinely due by ``now`` is drained first).
        Returns (fetch_latency_seconds, bytes); (0, 0) on a hit. A
        coalesced fetch is charged only the remaining wait to the
        in-flight transfer's ETA."""
        self.poll(now)
        plan = self.start_fetch(server_id, adapter_id, now=now)
        if plan.hit:
            return 0.0, 0
        self.finish(plan)
        return max(0.0, plan.eta - now), plan.nbytes

    # -- GC (Fig 13 delete-after-copy) ------------------------------------
    def _gc(self, adapter_id: str) -> None:
        """Drop copies not in the desired placement, always keeping >= 1
        HBM copy cluster-wide. Skips adapters with transfers in flight:
        an in-flight fetch may be reading any surviving copy, so nothing
        is deleted until it lands (the hit-path GC races fixed here).
        Demoted copies land in the host cache, not the void."""
        if self.inflight_count(adapter_id):
            return
        want = self.desired.get(adapter_id)
        if not want:
            return
        holders = self.index[adapter_id]
        for sid in sorted(holders):
            if sid in want:
                continue
            if len(holders) == 1:
                break
            self.local[sid].discard(adapter_id)
            holders.discard(sid)
            self._demote(sid, adapter_id)
            self.evictions += 1

    def _demote(self, server_id: int, adapter_id: str) -> None:
        nbytes = self.meta[adapter_id].nbytes
        if self.host_cache_bytes <= 0 or nbytes > self.host_cache_bytes:
            return
        cache = self.host_cache[server_id]
        cache.pop(adapter_id, None)
        cache[adapter_id] = nbytes          # most-recently demoted last
        while sum(cache.values()) > self.host_cache_bytes:
            cache.pop(next(iter(cache)))    # evict LRU head

    # -- accounting -------------------------------------------------------
    def server_bytes(self, server_id: int) -> int:
        return sum(self.meta[a].nbytes for a in self.local[server_id])

    def host_cache_used(self, server_id: int) -> int:
        return sum(self.host_cache[server_id].values())

    def server_adapter_count(self, server_id: int) -> int:
        return len(self.local[server_id])

    def max_adapters_per_server(self) -> int:
        return max((len(s) for s in self.local), default=0)

    def total_bytes(self) -> int:
        return sum(self.server_bytes(s) for s in range(self.n_servers))

    def check_invariant(self) -> bool:
        return all(len(self.index[a]) >= 1 for a in self.meta)

    # -- debug invariant hook (shared with the model checker) -------------
    def check_invariants(self, now: float = 0.0, routing=None,
                         raise_on_violation: bool = False) -> List[str]:
        """Full safety-invariant sweep (min-copy, index consistency,
        tier exclusivity, in-flight source residency, retired-server
        silence, link occupancy) — the same predicate the protocol
        model checker evaluates at every explored state."""
        from .invariants import check_store_invariants
        errs = check_store_invariants(self, now, routing)
        if errs and raise_on_violation:
            raise RuntimeError("AdapterStore invariant violation:\n  "
                               + "\n  ".join(errs))
        return errs

    def _debug_check(self, now: float = 0.0) -> None:
        if runtime_checks_enabled():
            self.check_invariants(now, raise_on_violation=True)


# Legacy name: the synchronous pool grew into the tiered store; callers
# using seed/apply_placement/ensure_local/check_invariant are unchanged.
DistributedAdapterPool = AdapterStore
