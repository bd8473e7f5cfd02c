"""Routing table + phi-weighted request routing (paper Fig 11 steps 1-2).

The routing table holds (adapter_id, server_id, phi) tuples with
sum(phi) = 1 per adapter; a request is dispatched to server s with
probability phi_s. Toppings-style request-level routing is implemented in
baselines.py (it bypasses phi and queries live server load).
"""
from __future__ import annotations

import random
from typing import Dict, List, Optional, Tuple

from .types import Placement


class UnknownAdapterError(KeyError):
    """Raised when routing is asked about an adapter with no placement
    entry (never placed, or dropped from the routing table)."""

    def __init__(self, adapter_id: str):
        super().__init__(adapter_id)
        self.adapter_id = adapter_id

    def __str__(self) -> str:
        return (f"adapter {self.adapter_id!r} has no entry in the routing "
                f"table — it was never placed (or was dropped by a "
                f"placement update)")


class RetiredServerError(RuntimeError):
    """Raised when a placement or route would touch a retired server —
    the control plane's loss-free-drain guarantee made loud."""


class RoutingTable:
    def __init__(self, placement: Optional[Placement] = None, seed: int = 0):
        self._rng = random.Random(seed)
        self._table: Dict[str, List[Tuple[int, float]]] = {}
        self.request_counts: Dict[str, int] = {}
        self.token_counts: Dict[str, float] = {}
        self.blocked: set = set()          # retired server ids
        if placement:
            self.update(placement)

    def update(self, placement: Placement) -> None:
        table = {}
        for aid, entry in placement.items():
            items = sorted(entry.items())
            bad = [sid for sid, _ in items if sid in self.blocked]
            if bad:
                raise RetiredServerError(
                    f"placement routes adapter {aid!r} to retired "
                    f"server(s) {bad}")
            tot = sum(phi for _, phi in items)
            assert tot > 0, f"adapter {aid} has zero total phi"
            table[aid] = [(sid, phi / tot) for sid, phi in items]
        self._table = table

    def remove_adapter(self, adapter_id: str) -> None:
        """Drop an adapter's routing entry (runtime deregister): every
        subsequent route for it raises ``UnknownAdapterError``. No-op if
        it was never routed."""
        self._table.pop(adapter_id, None)

    def block_server(self, server_id: int) -> None:
        """Retire ``server_id`` from routing: strip it from every entry
        (renormalizing phi over the survivors) and refuse it in all
        future placements. An adapter whose *only* route was the blocked
        server raises — the drain that preceded retirement must already
        have re-placed it."""
        self.blocked.add(server_id)
        for aid, entry in list(self._table.items()):
            kept = [(sid, phi) for sid, phi in entry if sid != server_id]
            if len(kept) == len(entry):
                continue
            if not kept:
                raise RetiredServerError(
                    f"adapter {aid!r} has no route left after retiring "
                    f"server {server_id}")
            tot = sum(phi for _, phi in kept)
            self._table[aid] = [(sid, phi / tot) if tot > 0
                                else (sid, 1.0 / len(kept))
                                for sid, phi in kept]

    def unblock_server(self, server_id: int) -> None:
        """Re-admit a previously blocked server (crash -> restore in the
        fault plane): future placements may route to it again. Existing
        entries are untouched — the next placement update re-spreads
        phi."""
        self.blocked.discard(server_id)

    def servers(self, adapter_id: str) -> List[Tuple[int, float]]:
        try:
            return list(self._table[adapter_id])
        except KeyError:
            raise UnknownAdapterError(adapter_id) from None

    def route(self, adapter_id: str, tokens: float = 0.0) -> int:
        return self.route_detailed(adapter_id, tokens)[0]

    def route_detailed(self, adapter_id: str, tokens: float = 0.0
                       ) -> Tuple[int, List[Tuple[int, float]]]:
        """Route plus the adapter's full phi entry. The alternates feed
        the data plane's ``FetchPlan``: on a miss, a remote read prefers
        peers the adapter is *placed* on (they are guaranteed warm and
        phi-weighted), not just any current holder."""
        try:
            entry = self._table[adapter_id]
        except KeyError:
            raise UnknownAdapterError(adapter_id) from None
        self.request_counts[adapter_id] = \
            self.request_counts.get(adapter_id, 0) + 1
        self.token_counts[adapter_id] = \
            self.token_counts.get(adapter_id, 0.0) + tokens
        if len(entry) == 1:
            return self._checked(entry[0][0]), list(entry)
        u = self._rng.random()
        acc = 0.0
        for sid, phi in entry:
            acc += phi
            if u <= acc:
                return self._checked(sid), list(entry)
        return self._checked(entry[-1][0]), list(entry)

    def _checked(self, sid: int) -> int:
        if sid in self.blocked:
            raise RetiredServerError(f"routed to retired server {sid}")
        return sid

    def reset_counts(self) -> Dict[str, int]:
        counts = self.request_counts
        self.request_counts = {}
        self.token_counts = {}
        return counts
