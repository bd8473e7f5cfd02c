"""Core types for the LORASERVE orchestrator control plane."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

# adapter_id -> {server_id: phi}, with sum(phi.values()) == 1 per adapter.
Placement = Dict[str, Dict[int, float]]


@dataclasses.dataclass(frozen=True)
class AdapterInfo:
    adapter_id: str
    rank: int
    nbytes: int = 0          # host-memory footprint (for pool accounting)


@dataclasses.dataclass
class PlacementContext:
    """Everything a placement policy may look at."""
    n_servers: int
    adapters: List[AdapterInfo]
    demand_tps: Dict[str, float]                  # projected TPS per adapter
    operating_points: Dict[int, float]            # rank -> max TPS under SLO
    prev_placement: Optional[Placement] = None
    # with autoscaling the placeable fleet is no longer 0..n-1: retired
    # and draining servers drop out while their ids stay stable
    server_ids: Optional[List[int]] = None

    def servers(self) -> List[int]:
        """Physical ids of the placeable servers (len == n_servers)."""
        return (list(self.server_ids) if self.server_ids is not None
                else list(range(self.n_servers)))

    def adapter(self, adapter_id: str) -> AdapterInfo:
        return next(a for a in self.adapters if a.adapter_id == adapter_id)


@dataclasses.dataclass
class PlacementStats:
    target_util: float
    rank_server_budget: Dict[int, int]
    server_util: Dict[int, float]
    moved_adapters: int = 0


def placement_servers(placement: Placement, adapter_id: str) -> List[int]:
    return sorted(placement.get(adapter_id, {}).keys())


def servers_to_adapters(placement: Placement) -> Dict[int, List[str]]:
    out: Dict[int, List[str]] = {}
    for aid, entry in placement.items():
        for sid in entry:
            out.setdefault(sid, []).append(aid)
    return out
