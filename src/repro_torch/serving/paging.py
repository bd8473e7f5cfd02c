"""Unified paging (S-LoRA, paper §II-B.2): one page pool in GPU memory
backs BOTH the KV cache blocks and the active LoRA adapter slices, so
thousands of adapters can coexist with long sequences without a static
partition. This is the per-server memory substrate underneath the
orchestrator's placement decisions — the placement controls *which*
adapters a server needs, unified paging controls *how* they share HBM
with the KV cache.

Semantics implemented:
  * fixed pool of pages (page = `page_tokens` KV slots = `page_bytes`);
  * KV sequences allocate ceil(len/page_tokens) pages, grow page-by-page
    during decode;
  * adapters allocate ceil(adapter_bytes/page_bytes) pages on first use
    (paged in from host), and are LRU-evicted when the pool is under
    pressure from KV growth — never while pinned (actively co-batched);
  * fragmentation-free by construction (page granularity), stats exposed.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set


class OutOfPages(RuntimeError):
    pass


@dataclasses.dataclass
class _Alloc:
    pages: List[int]
    kind: str                    # "kv" | "adapter"
    pinned: bool = False
    last_use: int = 0


class UnifiedPagePool:
    def __init__(self, n_pages: int, page_tokens: int = 16,
                 page_bytes: int = 2 << 20):
        self.n_pages = n_pages
        self.page_tokens = page_tokens
        self.page_bytes = page_bytes
        self._free: List[int] = list(range(n_pages))
        self._allocs: Dict[str, _Alloc] = {}
        self._clock = 0
        # telemetry
        self.adapter_page_ins = 0
        self.adapter_evictions = 0

    # -- internals -------------------------------------------------------
    def _take(self, n: int, for_kind: str) -> List[int]:
        while len(self._free) < n:
            if not self._evict_one(prefer_not=for_kind):
                raise OutOfPages(
                    f"need {n} pages, {len(self._free)} free, nothing "
                    f"evictable")
        pages = self._free[:n]
        del self._free[:n]
        return pages

    def _evict_one(self, prefer_not: str) -> bool:
        """LRU-evict an unpinned adapter (KV blocks are never evicted —
        they hold live sequence state)."""
        cands = [(a.last_use, key) for key, a in self._allocs.items()
                 if a.kind == "adapter" and not a.pinned]
        if not cands:
            return False
        _, key = min(cands)
        self.free(key)
        self.adapter_evictions += 1
        return True

    # -- KV sequences ------------------------------------------------------
    def alloc_kv(self, seq_id: str, n_tokens: int) -> None:
        assert seq_id not in self._allocs
        n = -(-n_tokens // self.page_tokens)
        self._allocs[seq_id] = _Alloc(self._take(max(1, n), "kv"), "kv")

    def grow_kv(self, seq_id: str, n_tokens: int) -> None:
        """Ensure capacity for n_tokens (decode growth)."""
        a = self._allocs[seq_id]
        need = -(-n_tokens // self.page_tokens)
        if need > len(a.pages):
            a.pages.extend(self._take(need - len(a.pages), "kv"))

    # -- adapters ----------------------------------------------------------
    def ensure_adapter(self, adapter_id: str, nbytes: int) -> bool:
        """Page the adapter in if absent. Returns True on a page-in
        (host->device transfer happened), False on a hit."""
        self._clock += 1
        key = f"adapter/{adapter_id}"
        if key in self._allocs:
            self._allocs[key].last_use = self._clock
            return False
        n = max(1, -(-nbytes // self.page_bytes))
        self._allocs[key] = _Alloc(self._take(n, "adapter"), "adapter",
                                   last_use=self._clock)
        self.adapter_page_ins += 1
        return True

    def pin_adapter(self, adapter_id: str, pinned: bool = True) -> None:
        self._allocs[f"adapter/{adapter_id}"].pinned = pinned

    def has_adapter(self, adapter_id: str) -> bool:
        return f"adapter/{adapter_id}" in self._allocs

    # -- common ------------------------------------------------------------
    def free(self, key: str) -> None:
        a = self._allocs.pop(key)
        self._free.extend(a.pages)

    def free_kv(self, seq_id: str) -> None:
        self.free(seq_id)

    # -- stats ---------------------------------------------------------------
    @property
    def used_pages(self) -> int:
        return self.n_pages - len(self._free)

    def pages_by_kind(self) -> Dict[str, int]:
        out = {"kv": 0, "adapter": 0}
        for a in self._allocs.values():
            out[a.kind] += len(a.pages)
        return out

    def check_invariant(self) -> bool:
        seen: Set[int] = set(self._free)
        total = len(self._free)
        for a in self._allocs.values():
            seen.update(a.pages)
            total += len(a.pages)
        return total == self.n_pages and len(seen) == self.n_pages
