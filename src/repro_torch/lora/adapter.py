"""LoRA adapters of the PyTorch port: single-adapter weight dicts and
stacked multi-adapter banks, the counterpart of the JAX package's
``lora/adapter.py``.

A *bank* holds ``n_adapters`` adapters padded to a common ``max_rank``.
Adapters of rank r < max_rank are zero-padded (rows/cols beyond r
contribute nothing numerically but fully participate in the matmuls).
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.models.common import dense_init


@dataclasses.dataclass(frozen=True)
class Adapter:
    """Metadata for one serving adapter (the unit the orchestrator places)."""
    adapter_id: str
    rank: int
    base_model: str = "llama-7b-paper"

    def nbytes(self, cfg) -> int:
        """Host-memory footprint (bf16): A+B on every target, all layers."""
        total = 0
        for t in cfg.lora.targets:
            in_dim = _target_in_dim(cfg, t)
            out_dim = _target_out_dim(cfg, t)
            total += in_dim * self.rank + self.rank * out_dim
        return 2 * total * cfg.n_layers  # 2 bytes / param


def _target_out_dim(cfg, target: str) -> int:
    hd = cfg.resolved_head_dim or cfg.d_model
    H, Kv = cfg.n_heads or 1, cfg.n_kv_heads or 1
    if cfg.ssm is not None and cfg.ssm.kind == "rwkv6":
        return cfg.d_model
    if cfg.mla is not None:
        m = cfg.mla
        return {"q": H * (m.qk_nope_head_dim + m.qk_rope_head_dim),
                "k": m.kv_lora_rank + m.qk_rope_head_dim,
                "v": m.kv_lora_rank + m.qk_rope_head_dim,
                "o": cfg.d_model}[target]
    return {"q": H * hd, "k": Kv * hd, "v": Kv * hd, "o": cfg.d_model}[target]


def _target_in_dim(cfg, target: str) -> int:
    if target != "o":
        return cfg.d_model
    if cfg.ssm is not None and cfg.ssm.kind == "rwkv6":
        return cfg.d_model
    if cfg.mla is not None:
        return cfg.n_heads * cfg.mla.v_head_dim
    return cfg.n_heads * cfg.resolved_head_dim


def init_adapter(cfg, rank: int, gen: torch.Generator, n_layers=None,
                 dtype=torch.float32):
    """Single adapter: {target: {"A": (L,d,r), "B": (L,r,out)}} on the
    generator's device. A ~ N(0, 1/d); B = 0 (standard LoRA init)."""
    L = n_layers if n_layers is not None else cfg.n_layers
    out = {}
    for t in cfg.lora.targets:
        o = _target_out_dim(cfg, t)
        in_dim = _target_in_dim(cfg, t)
        out[t] = {
            "A": dense_init(gen, (L, in_dim, rank), fan_in=in_dim,
                            dtype=dtype),
            "B": torch.zeros((L, rank, o), dtype=dtype, device=gen.device),
        }
    return out


def adapter_key(seed: int, adapter_id: str) -> int:
    """Deterministic per-adapter generator seed: the same adapter id always
    yields the same weights, no matter which bank subset it lands in."""
    return (int(seed) << 32) | (zlib.crc32(adapter_id.encode()) & 0x7FFFFFFF)


def _generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def _stack_adapters(singles):
    """Stack per-adapter trees along a new adapter axis 1."""
    return {t: {k: torch.stack([s[t][k] for s in singles], dim=1)
                for k in ("A", "B")}
            for t in singles[0]}


def init_bank_from(cfg, adapter_ranks: Dict[str, int], seed: int,
                   n_layers=None, dtype=torch.float32, device="cpu"):
    """Bank {target: {"A": (L, Na, d, max_r), "B": (L, Na, max_r, o)}} over
    ``sorted(adapter_ranks)``, padded to the *subset's* max rank; weights
    keyed per adapter id via ``adapter_key``."""
    ids = sorted(adapter_ranks)
    if not ids:
        raise ValueError("init_bank_from needs at least one adapter")
    max_r = max(adapter_ranks.values())
    singles = []
    for aid in ids:
        a = init_adapter(cfg, adapter_ranks[aid],
                         _generator(adapter_key(seed, aid), device),
                         n_layers=n_layers, dtype=dtype)
        singles.append(pad_adapter(a, max_r))
    return _stack_adapters(singles)


def pad_adapter(adapter, max_r: int):
    """One adapter's ``{target: {"A": (L, d_in, r), "B": (L, r, d_out)}}``
    zero-padded to rank ``max_r``: A along its last axis, B along its
    middle one. (The JAX package's ``pad_rank`` tells A from B by shape
    and pads a B whose d_out is below ``max_r`` as an A, which breaks the
    bank it builds; the port pads by role, ROADMAP C10.)"""
    return {t: {"A": F.pad(w["A"], (0, max_r - w["A"].shape[-1])),
                "B": F.pad(w["B"], (0, 0, 0, max_r - w["B"].shape[-2]))}
            for t, w in adapter.items()}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def bank_nbytes(bank) -> int:
    return sum(x.numel() * x.element_size() for x in _leaves(bank))
