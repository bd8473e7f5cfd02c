"""LoRABank of the PyTorch port: one descriptor for a server's stacked
adapter bank, in either of two layouts (the counterpart of the JAX
package's ``lora/bank.py``).

``padded`` — the paper-faithful baseline: every adapter zero-padded to
the hosted subset's max rank, one stacked bank, every co-batched request
pays max-rank compute.

``bucketed`` — adapters grouped into power-of-two rank buckets, each
bucket its own stacked bank at the *bucket* rank. Both layouts hold
numerically identical adapter weights (padding is inert), so switching
``bank_mode`` changes cost, never tokens.

``LoRABank.data`` is what the model consumes:
  padded   — {target: {"A": (L, Na, d, r), "B": (L, Na, r, o)}}
  bucketed — tuple of such dicts, one per bucket (ascending bucket rank).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.device import resolve_device

from .adapter import (_generator, _stack_adapters, adapter_key, bank_nbytes,
                      init_adapter, init_bank_from, pad_rank)


def rank_bucket(rank: int) -> int:
    """Smallest power of two >= rank (bucket 8 serves ranks 5..8)."""
    if rank <= 0:
        raise ValueError(f"rank must be positive, got {rank}")
    return 1 << (rank - 1).bit_length()


@dataclasses.dataclass(frozen=True)
class LoRABank:
    """Descriptor + device data for one server's hosted adapter subset."""
    mode: str                          # "padded" | "bucketed"
    adapter_ids: Tuple[str, ...]       # sorted; index = model adapter idx
    ranks: Tuple[int, ...]             # aligned with adapter_ids
    data: Any                          # model-facing bank dict(s)
    bucket_ranks: Tuple[int, ...] = ()   # ascending; empty for padded
    bucket_counts: Tuple[int, ...] = ()  # adapters per bucket
    adapter_bucket: Optional[torch.Tensor] = None  # (Na,) adapter -> bucket
    adapter_local: Optional[torch.Tensor] = None   # (Na,) row within bucket

    @property
    def n_adapters(self) -> int:
        return len(self.adapter_ids)

    @property
    def max_rank(self) -> int:
        return max(self.ranks)

    @property
    def signature(self) -> tuple:
        """Layout identity: the bank's shape until it reshapes."""
        if self.mode == "padded":
            return ("padded", self.max_rank, self.n_adapters)
        return ("bucketed",
                tuple(zip(self.bucket_ranks, self.bucket_counts)))

    def nbytes(self) -> int:
        return bank_nbytes(self.data)

    def index(self, adapter_id: str) -> int:
        return self.adapter_ids.index(adapter_id)

    def lora_idx(self, adapter_idx: torch.Tensor) -> torch.Tensor:
        """Global adapter indices (B,) -> the index tensor the model
        callback consumes: the same (B,) for padded, a stacked (B, 2) of
        (bucket, local-row) for bucketed."""
        adapter_idx = adapter_idx.to(torch.int32)
        if self.mode == "padded":
            return adapter_idx
        ai = adapter_idx.long()
        return torch.stack([self.adapter_bucket[ai], self.adapter_local[ai]],
                           dim=-1)

    def _rows(self, adapter_id: str):
        """(bank dict holding the adapter, its stack row, its rank)."""
        i = self.index(adapter_id)
        r = self.ranks[i]
        if self.mode == "padded":
            return self.data, i, r
        return (self.data[int(self.adapter_bucket[i])],
                int(self.adapter_local[i]), r)

    def get_adapter(self, adapter_id: str):
        """One adapter's unpadded weights ``{target: {"A": (L, d, r),
        "B": (L, r, o)}}`` (copies)."""
        tree, row, r = self._rows(adapter_id)
        return {t: {"A": tree[t]["A"][:, row, :, :r].clone(),
                    "B": tree[t]["B"][:, row, :r, :].clone()}
                for t in tree}

    def set_adapter(self, adapter_id: str, weights) -> "LoRABank":
        """Overwrite ``adapter_id``'s rows with ``weights``; padding beyond
        the adapter's rank is untouched and stays zero. The JAX bank
        returns a new bank; this one writes its tensors in place and
        returns itself."""
        tree, row, r = self._rows(adapter_id)
        for t in tree:
            A, B = tree[t]["A"], tree[t]["B"]
            A[:, row, :, :r] = weights[t]["A"].to(A.device, A.dtype)
            B[:, row, :r, :] = weights[t]["B"].to(B.device, B.dtype)
        return self


def build_bank(cfg, adapter_ranks: Dict[str, int], seed: int = 0, *,
               mode: str = "padded", n_layers=None, dtype=torch.float32,
               device="cuda") -> LoRABank:
    """Build a bank over ``sorted(adapter_ranks)`` in the given layout.

    Weights come from one ``torch.Generator`` per adapter, seeded from
    ``seed`` and the adapter id (``adapter_key``), so the same adapter
    carries bit-identical weights in a padded bank, a bucketed bank, or a
    rebuilt bank after a placement change. (They are not the JAX
    package's numbers: tests carry weights across with ``bridge``.)
    """
    dev = resolve_device(device)
    ids = sorted(adapter_ranks)
    if not ids:
        raise ValueError("build_bank needs at least one adapter")
    ranks = [adapter_ranks[a] for a in ids]
    if mode == "padded":
        data = init_bank_from(cfg, adapter_ranks, seed, n_layers=n_layers,
                              dtype=dtype, device=dev)
        return LoRABank("padded", tuple(ids), tuple(ranks), data)
    if mode != "bucketed":
        raise ValueError(f"unknown bank_mode {mode!r}")

    buckets = sorted({rank_bucket(r) for r in ranks})
    members: Dict[int, list] = {b: [] for b in buckets}
    bucket_of, local_of = [], []
    for aid, r in zip(ids, ranks):
        b = rank_bucket(r)
        bucket_of.append(buckets.index(b))
        local_of.append(len(members[b]))
        members[b].append(aid)
    data = []
    for b in buckets:
        singles = []
        for aid in members[b]:
            a = init_adapter(cfg, adapter_ranks[aid],
                             _generator(adapter_key(seed, aid), dev),
                             n_layers=n_layers, dtype=dtype)
            singles.append({t: {k: pad_rank(v, b) for k, v in w.items()}
                            for t, w in a.items()})
        data.append(_stack_adapters(singles))
    return LoRABank("bucketed", tuple(ids), tuple(ranks), tuple(data),
                    bucket_ranks=tuple(buckets),
                    bucket_counts=tuple(len(members[b]) for b in buckets),
                    adapter_bucket=torch.tensor(bucket_of, dtype=torch.int32,
                                                device=dev),
                    adapter_local=torch.tensor(local_of, dtype=torch.int32,
                                               device=dev))
