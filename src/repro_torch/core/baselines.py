"""Baseline placement/routing policies from the paper's evaluation (§V-D):

- S-LoRA Random: static uniform-random adapter->server assignment (what
  Company X runs today per the paper).
- S-LoRA Contiguous: adapters sorted by rank, equal contiguous chunks per
  server (rank-homogeneous servers, load-oblivious).
- Toppings: every adapter replicated on every server (the memory cost the
  paper's Fig 18-bottom charges it for); request-level load-aware routing
  picks the server with the least estimated outstanding work — rank-aware
  in service-time estimation but rank-agnostic in co-batching.
"""
from __future__ import annotations

import random
from typing import Dict, List, Optional

from .placement import assign_loraserve
from .types import AdapterInfo, Placement, PlacementContext


class LoraservePolicy:
    name = "loraserve"
    dynamic = True
    replicate_all = False

    def place(self, ctx: PlacementContext) -> Placement:
        placement, self.last_stats = assign_loraserve(ctx)
        return placement


class RandomPolicy:
    name = "slora-random"
    dynamic = False
    replicate_all = False

    def __init__(self, seed: int = 0):
        self.seed = seed

    def place(self, ctx: PlacementContext) -> Placement:
        rng = random.Random(self.seed)
        ids = ctx.servers()
        return {a.adapter_id: {rng.choice(ids): 1.0}
                for a in ctx.adapters}


class ContiguousPolicy:
    name = "slora-contiguous"
    dynamic = False
    replicate_all = False

    def place(self, ctx: PlacementContext) -> Placement:
        ordered = sorted(ctx.adapters, key=lambda a: a.rank)
        ids = ctx.servers()
        per = -(-len(ordered) // len(ids))
        placement: Placement = {}
        for i, a in enumerate(ordered):
            placement[a.adapter_id] = {ids[min(i // per, len(ids) - 1)]: 1.0}
        return placement


class ToppingsPolicy:
    name = "toppings"
    dynamic = False
    replicate_all = True     # assumes full replication (paper §II-B.2)

    def place(self, ctx: PlacementContext) -> Placement:
        ids = ctx.servers()
        return {a.adapter_id: {s: 1.0 / len(ids) for s in ids}
                for a in ctx.adapters}


POLICIES = {
    "loraserve": LoraservePolicy,
    "slora-random": RandomPolicy,
    "slora-contiguous": ContiguousPolicy,
    "toppings": ToppingsPolicy,
}
