"""The adapter store's safety invariants: a copy of
``check_store_invariants`` from the JAX package's ``analysis/protocol.py``
(its exhaustive model checker stays there). ``AdapterStore.
check_invariants`` and the opt-in ``REPRO_CHECK_INVARIANTS=1`` hook call
it on live objects."""
from __future__ import annotations

from typing import Dict, List

_EPS = 1e-12


def check_store_invariants(store, now: float = 0.0,
                           routing=None,
                           closed_world: bool = False) -> List[str]:
    """Safety invariants over a live ``AdapterStore`` (+ its network
    model, + optionally the routing table). Returns human-readable
    violation strings; empty list means the state is consistent.

    ``closed_world=True`` (the model checker) additionally requires the
    network's egress slots to match the store's in-flight plans exactly
    — every transfer in the model is store-driven, so an extra slot is a
    leaked ``end_transfer``. At runtime other traffic shares the links
    (e.g. tests pre-loading a link via ``begin_transfer``), so only the
    ``slots >= plans`` direction is checked there."""
    errs: List[str] = []
    failed = getattr(store, "failed", set())
    lost = getattr(store, "lost", set())
    for aid in sorted(store.meta):
        holders = store.index.get(aid, set())
        if not holders:
            # fault plane: a crash can legitimately kill the last HBM
            # copy — the adapter is *recovering* (not breached) while a
            # re-warm fetch is in flight, a host-tier copy survives on a
            # live server, or the durable SSD tier owns it (store.lost)
            recovering = (
                aid in lost
                or store.inflight_count(aid) > 0
                or any(aid in store.host_cache[s]
                       for s in range(store.n_servers)
                       if s not in failed))
            if not recovering:
                errs.append(f"min-copy: adapter {aid!r} has zero HBM "
                            f"copies cluster-wide")
        for s in holders:
            if s >= store.n_servers or aid not in store.local[s]:
                errs.append(f"index-consistent: index says {aid!r} on "
                            f"server {s} but the server does not hold it")
    for s in range(store.n_servers):
        for aid in store.local[s]:
            if s not in store.index.get(aid, set()):
                errs.append(f"index-consistent: server {s} holds {aid!r} "
                            f"but the index does not know")
        overlap = store.local[s] & set(store.host_cache[s])
        if overlap:
            errs.append(f"tier-exclusive: {sorted(overlap)} in both HBM "
                        f"and host tiers of server {s}")
        if store.host_cache_used(s) > store.host_cache_bytes:
            errs.append(f"host-cache-budget: server {s} host tier "
                        f"over budget")
    for (dest, aid), p in sorted(store._inflight.items()):
        if p.src_server >= 0 and aid not in store.local[p.src_server]:
            errs.append(
                f"inflight-src-resident: fetch of {aid!r} to server "
                f"{dest} sources server {p.src_server}, which no longer "
                f"holds a copy (GC-vs-fetch race)")
        if dest in store.retired:
            errs.append(f"retired-silent: in-flight fetch of {aid!r} "
                        f"targets retired server {dest}")
    for s in sorted(store.retired):
        if store.local[s] or store.host_cache[s]:
            errs.append(f"retired-silent: retired server {s} still "
                        f"holds copies")
        if store.inflight_from(s) or store.inflight_to(s):
            errs.append(f"retired-silent: retired server {s} still "
                        f"feeds transfers")
    for s in sorted(failed):
        # confirmed-dead silence: a crashed server holds nothing and
        # neither feeds nor receives transfers until restored
        if store.local[s] or store.host_cache[s]:
            errs.append(f"failed-silent: failed server {s} still "
                        f"holds copies")
        if store.inflight_from(s) or store.inflight_to(s):
            errs.append(f"failed-silent: failed server {s} still "
                        f"feeds transfers")
    net = store.network
    if net is not None:
        live_plans: Dict[int, int] = {}
        for p in store._inflight.values():
            if p.src_server >= 0 and p.eta > now + _EPS:
                live_plans[p.src_server] = \
                    live_plans.get(p.src_server, 0) + 1
        srcs = set(net._egress) | set(live_plans)
        for src in sorted(srcs):
            slots = len([t for t in net._egress.get(src, [])
                         if t > now + _EPS])
            plans = live_plans.get(src, 0)
            bad = (slots != plans) if closed_world else (slots < plans)
            if bad:
                errs.append(
                    f"link-occupancy: server {src} egress has {slots} "
                    f"occupied slots but {plans} live in-flight plans")
    if routing is not None:
        # a confirmed-dead (failed) server must never receive a route —
        # the chaos-plane invariant — alongside the retired-silent one
        dead = set(routing.blocked) | set(store.retired) | set(failed)
        for aid, entry in sorted(routing._table.items()):
            for sid, phi in entry:
                if sid in dead:
                    errs.append(f"retired-silent: routing entry for "
                                f"{aid!r} references dead server "
                                f"{sid}")
                if phi < -_EPS:
                    errs.append(f"routing: negative phi for {aid!r} on "
                                f"server {sid}")
            tot = sum(phi for _, phi in entry)
            if entry and abs(tot - 1.0) > 1e-6:
                errs.append(f"routing: phi for {aid!r} sums to {tot}")
    return errs
