"""LORASERVE adapter placement — Algorithm 1, faithfully.

Steps (paper §IV-A):
  1. Estimate per-adapter TPS demand; target utilization per server
     = sum_r rank_util(r) / n_servers, with rank_util(r) =
     sum_{a of rank r} demand(a) / operating_point(r).
  2. Server budget per rank = round(rank_util / target_util) — then
     remainder-adjusted so budgets sum to n_servers (every server gets a
     bin; budget-0 ranks flow to Step 4 exactly as in the paper).
  3. Fractional bin packing of each rank's adapters into its budget of
     bins; adapters split across bins get fractional routing weights phi
     (sum phi = 1). Overflow beyond a rank's bins spills to leftovers.
  4. Leftovers sorted by descending rank; each goes to the bin with the
     highest max-rank (>= its own rank if possible) and least utilization.
  5. Permute bins onto physical servers to maximize overlap with the
     previous placement (minimizes adapter migrations).
  6. The caller updates the routing table / pool from the returned
     Placement.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

from .types import AdapterInfo, Placement, PlacementContext, PlacementStats


class _Bin:
    __slots__ = ("shares", "util", "ranks")

    def __init__(self):
        self.shares: Dict[str, float] = {}   # adapter -> util placed here
        self.util: float = 0.0
        self.ranks: List[int] = []

    @property
    def max_rank(self) -> int:
        return max(self.ranks) if self.ranks else 0

    def add(self, adapter_id: str, util: float, rank: int) -> None:
        self.shares[adapter_id] = self.shares.get(adapter_id, 0.0) + util
        self.util += util
        self.ranks.append(rank)


def _rank_utils(ctx: PlacementContext) -> Dict[int, float]:
    out: Dict[int, float] = {}
    for a in ctx.adapters:
        load = ctx.demand_tps.get(a.adapter_id, 0.0)
        op = ctx.operating_points[a.rank]
        out[a.rank] = out.get(a.rank, 0.0) + load / op
    return out


def _budgets(rank_util: Dict[int, float], target_util: float,
             n_servers: int) -> Dict[int, int]:
    """Step 2 + remainder fix-up so sum(budgets) == n_servers."""
    raw = {r: u / target_util if target_util > 0 else 0.0
           for r, u in rank_util.items()}
    budget = {r: int(round(v)) for r, v in raw.items()}
    total = sum(budget.values())
    # adjust by largest/smallest fractional remainder
    while total < n_servers:
        r = max(raw, key=lambda r: raw[r] - budget[r])
        budget[r] += 1
        total += 1
    while total > n_servers:
        cands = [r for r in raw if budget[r] > 0]
        r = min(cands, key=lambda r: raw[r] - budget[r])
        budget[r] -= 1
        total -= 1
    return budget


def _fractional_bin_packing(adapters: List[Tuple[str, float, int]],
                            n_bins: int, capacity: float,
                            bins: List[_Bin]) -> List[Tuple[str, float, int]]:
    """Pack (adapter_id, util, rank) items into n_bins fresh bins appended
    to `bins`. Adapters exceeding remaining capacity are split (fractional
    phi). Returns overflow items that did not fit in this rank's budget."""
    mine = [_Bin() for _ in range(n_bins)]
    bins.extend(mine)
    overflow: List[Tuple[str, float, int]] = []
    if not mine:
        return adapters
    items = sorted(adapters, key=lambda t: -t[1])
    bi = 0
    for aid, util, rank in items:
        remaining = util
        while remaining > 1e-12 and bi < len(mine):
            space = capacity - mine[bi].util
            if space <= 1e-12:
                bi += 1
                continue
            placed = min(space, remaining)
            mine[bi].add(aid, placed, rank)
            remaining -= placed
        if remaining > 1e-12:
            overflow.append((aid, remaining, rank))
    return overflow


def _allocate_leftovers(leftovers: List[Tuple[str, float, int]],
                        bins: List[_Bin], capacity: float) -> None:
    """Step 4: descending-rank; prefer bins whose max rank >= adapter rank
    *if possible* (paper's wording) — i.e. only while they have capacity —
    else fall back to the least-utilized bin."""
    for aid, util, rank in sorted(leftovers, key=lambda t: -t[2]):
        eligible = [b for b in bins
                    if b.max_rank >= rank and b.util + util <= capacity]
        pool = eligible or bins
        target = min(pool, key=lambda b: (b.util, -b.max_rank))
        target.add(aid, util, rank)


def _permute(bins: List[_Bin], prev: Optional[Placement],
             server_ids: List[int]) -> List[int]:
    """Step 5: greedy max-overlap matching bins -> physical server ids
    (with autoscaling these need not be 0..n-1)."""
    if not prev:
        return list(server_ids[:len(bins)])
    prev_sets: Dict[int, set] = {s: set() for s in server_ids}
    for aid, entry in prev.items():
        for sid in entry:
            if sid in prev_sets:
                prev_sets[sid].add(aid)
    assigned = [-1] * len(bins)
    free = set(server_ids)
    order = sorted(range(len(bins)),
                   key=lambda i: -len(bins[i].shares))
    for i in order:
        keys = set(bins[i].shares)
        best = max(free, key=lambda s: len(keys & prev_sets[s]))
        assigned[i] = best
        free.discard(best)
    return assigned


def assign_loraserve(ctx: PlacementContext) -> Tuple[Placement,
                                                     PlacementStats]:
    """Algorithm 1: ASSIGNLORASERVE."""
    n = len(ctx.servers())
    # -- Step 1
    rank_util = _rank_utils(ctx)
    total_util = sum(rank_util.values())
    target_util = total_util / n if n else 0.0
    if target_util <= 0:
        target_util = 1e-9
    # -- Step 2
    budget = _budgets(rank_util, target_util, n)
    # -- Step 3
    by_rank: Dict[int, List[Tuple[str, float, int]]] = {}
    for a in ctx.adapters:
        util = ctx.demand_tps.get(a.adapter_id, 0.0) / \
            ctx.operating_points[a.rank]
        by_rank.setdefault(a.rank, []).append((a.adapter_id, util, a.rank))
    bins: List[_Bin] = []
    leftovers: List[Tuple[str, float, int]] = []
    for rank in sorted(by_rank, reverse=True):
        over = _fractional_bin_packing(by_rank[rank], budget.get(rank, 0),
                                       target_util, bins)
        leftovers.extend(over)
    # -- Step 4
    _allocate_leftovers(leftovers, bins, target_util)
    # -- Step 5
    server_of_bin = _permute(bins, ctx.prev_placement, ctx.servers())
    # -- Build placement with normalized phi
    placement: Placement = {}
    for b, sid in zip(bins, server_of_bin):
        for aid, util in b.shares.items():
            placement.setdefault(aid, {})
            placement[aid][sid] = placement[aid].get(sid, 0.0) + util
    for a in ctx.adapters:
        aid = a.adapter_id
        entry = placement.setdefault(aid, {})
        if not entry:
            # zero-demand adapter: park on least-utilized bin's server
            i = min(range(len(bins)), key=lambda i: bins[i].util)
            entry[server_of_bin[i]] = 1.0
            continue
        tot = sum(entry.values())
        if tot <= 0:
            # zero-demand adapters land on one leftover bin: equal phi
            for sid in entry:
                entry[sid] = 1.0 / len(entry)
        else:
            for sid in entry:
                entry[sid] = entry[sid] / tot
    moved = 0
    if ctx.prev_placement:
        for aid, entry in placement.items():
            prev_s = set(ctx.prev_placement.get(aid, {}))
            moved += len(set(entry) - prev_s)
    stats = PlacementStats(
        target_util=target_util,
        rank_server_budget=budget,
        server_util={server_of_bin[i]: bins[i].util
                     for i in range(len(bins))},
        moved_adapters=moved,
    )
    return placement, stats
