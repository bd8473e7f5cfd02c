"""Mesh-sharded serving: the sharding layer of the engine's ``mesh=``
mode (the counterpart of the JAX package's ``serving/sharding.py``).

``EngineSharding`` binds one rank's ``TensorParallel`` to an engine and
owns every placement decision over "model" (tp), for every family:

* base params — the JAX package's name lists (``models/common.py``
  ``_COL``/``_ROW``/``_EXPERT``/``_VEC_COL``/``_EMBED``), as
  ``PARAM_SPLIT``: column-parallel projections (``wq wk wv w1 w3 ws1
  ws3``, MLA's ``w_uk w_uv``, Mamba2's ``w_xz w_dt``, RWKV-6's ``w_r w_k
  w_v w_g wk_cm`` and its decay ``wa2``) and their per-head vectors (the
  q/k/v biases, ``dt_bias A_log D ln_y``, ``w0 u ln_x``) take the rank's
  heads or channels; row-parallel ones (``wo w2 ws2 w_out w_o wv_cm``)
  the matching rows; the routed experts (``we1 we2 we3``) the rank's E/tp
  experts; ``embed`` its V/tp rows and ``lm_head`` its V/tp columns (a
  tied head reads the embedding's rows), replicated where tp does not
  divide V, as the JAX ``fit_spec`` replicates a dim the mesh does not
  divide. Everything else is replicated: the norms, the router, MLA's
  ``w_dkv``/``ln_kv``, Mamba2's ``w_bc``, RWKV-6's token-shift mixes and
  ``wa1``, the VLM's gates (a placement choice; no number changes). Two
  column splits are not one contiguous range: Mamba2's ``w_xz`` is ``[x |
  z]`` and a rank takes its heads' columns of both halves; and where tp
  does not divide the kv heads, ``wk``/``wv`` (and ``bk``/``bv``) take
  the kv heads the rank's query heads read, duplicated across ranks (the
  JAX ``_regroup_plan``; ``models.attention.local_kv_heads``);
* caches — the rank's heads: kv heads (regrouped where needed), cross
  K/V heads, Mamba2 and WKV heads; MLA's latent ``c``/``kr`` and the
  RWKV-6 token shifts whole (``models.model.init_cache(tp=...)``);
* LoRA banks — co-sharded: every bucket's A split along d_in, its B
  along d_out with the column split of the projection it adds to, so the
  kernels run on the rank's slices and one all-reduce of the rank-r
  intermediate joins them (``lora.batched``). MLA's ``k`` adds to the
  replicated ``w_dkv`` output: its B is split evenly and the delta
  all-gathered.

Over "data" (dp) base weights and banks are replicated (the JAX
``bank_spec`` splits over "model" only), and ``slot_rows`` is the rule
of the slot batch: it splits over dp only where dp divides the engine's
``max_batch``, as the JAX ``EngineSharding.batch_axes``; otherwise every
dp replica runs every slot.

Where the JAX package falls back to replicating a dim that the mesh
does not divide (``fit_spec``), this one refuses the config, V aside:
heads, kv heads that no regroup fits, d_ff, d_model, Mamba2/RWKV-6 heads
or experts that tp does not divide.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch import nn

from repro_torch.launch.mesh import TensorParallel
from repro_torch.lora.bank import LoRABank
from repro_torch.models.attention import local_kv_heads

# parameter name -> the axis a rank slices (1: column-parallel, 0:
# row-parallel, a per-head or per-channel vector, or the expert dim);
# every other parameter is replicated
PARAM_SPLIT = {
    # attention: GQA, cross-attention, MLA
    "wq": 1, "wk": 1, "wv": 1, "bq": 0, "bk": 0, "bv": 0, "wo": 0,
    "w_uk": 1, "w_uv": 1,
    # SwiGLU, shared experts, routed experts
    "w1": 1, "w3": 1, "w2": 0, "ws1": 1, "ws3": 1, "ws2": 0,
    "we1": 0, "we2": 0, "we3": 0,
    # Mamba2
    "w_xz": 1, "w_dt": 1, "dt_bias": 0, "A_log": 0, "D": 0, "ln_y": 0,
    "w_out": 0,
    # RWKV-6
    "w_r": 1, "w_k": 1, "w_v": 1, "w_g": 1, "w_o": 0, "w0": 0, "wa2": 1,
    "u": 0, "ln_x": 0, "wk_cm": 1, "wv_cm": 0,
    # the vocabulary: rows of the embedding, columns of the head
    "embed": 0, "lm_head": 1,
}
_VOCAB = ("embed", "lm_head")
_KV = ("wk", "wv", "bk", "bv")           # kv-head columns (regrouped)


def _refuse(cfg, what, n, tp):
    raise ValueError(f"{cfg.name}: {what}={n} is not divisible by "
                     f"tp={tp}; a layout that replicates it is not "
                     "ported (ROADMAP C5)")


def slot_rows(mesh, max_batch: int):
    """The slot rows [lo, hi) that this rank's dp replica runs: its
    max_batch / dp where dp divides ``max_batch``, every slot otherwise
    (the JAX ``EngineSharding.batch_axes``: the batch shards over "data",
    whose size is ``batch_shard_size``, only when divisible). ``mesh``
    None is one device."""
    n = 1 if mesh is None else mesh.dp.size
    if n == 1 or max_batch % n:
        return 0, max_batch
    w = max_batch // n
    return mesh.dp.rank * w, (mesh.dp.rank + 1) * w


def _kv_columns(cfg, rank: int, size: int):
    """The (d_out) columns of ``wk``/``wv`` that ``rank`` holds: the kv
    head of each of its local kv heads (``local_kv_heads`` of them,
    consecutive duplicates of Kv * rep "virtual" heads), head_dim columns
    each."""
    hd, Kv = cfg.resolved_head_dim, cfg.n_kv_heads
    n = local_kv_heads(cfg, size)
    rep = n * size // Kv
    heads = [v // rep for v in range(rank * n, (rank + 1) * n)]
    return torch.tensor([h * hd + i for h in heads for i in range(hd)])


def _xz_columns(length: int, rank: int, size: int):
    """Mamba2's ``w_xz`` = [x | z], ``length`` = 2 inner: the rank's heads'
    columns of both halves."""
    half = length // 2
    w = half // size
    own = torch.arange(rank * w, (rank + 1) * w)
    return torch.cat([own, own + half])


class EngineSharding:
    """Placement for one rank of a tensor-parallel engine."""

    def __init__(self, tp: TensorParallel, cfg):
        n = tp.size
        dims = {"d_model": cfg.d_model}
        if cfg.n_heads:
            dims["n_heads"] = cfg.n_heads
        if cfg.moe is not None:
            e = cfg.moe
            dims["n_experts"] = e.n_experts
            dims["n_shared_experts * d_ff_expert"] = \
                e.n_shared_experts * e.d_ff_expert
        else:
            dims["d_ff"] = cfg.d_ff
        if cfg.mla is not None:
            dims["kv_lora_rank + qk_rope_head_dim"] = \
                cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim
        if cfg.ssm is not None:
            s = cfg.ssm
            width = s.expand * cfg.d_model if s.kind == "mamba2" \
                else cfg.d_model
            dims[f"{s.kind} heads"] = width // s.head_dim
        for what, v in dims.items():
            if v % n:
                _refuse(cfg, what, v, n)
        self.tp, self.cfg = tp, cfg
        # the kv-head columns of GQA and cross-attention (MLA has none)
        self._gqa = bool(cfg.n_heads) and cfg.mla is None
        # the embedding and the head split only where tp divides V
        self.vocab_split = cfg.vocab_size % n == 0

    def axis(self, name: str):
        """The axis a rank slices of parameter ``name``; None where it is
        replicated."""
        if name in _VOCAB and not self.vocab_split:
            return None
        return PARAM_SPLIT.get(name)

    # -- the split of one tensor ------------------------------------------
    def index(self, name: str, length: int, rank=None):
        """The indices along its split axis that ``rank`` (this rank by
        default) holds of parameter ``name``, whose split axis has
        ``length`` entries (2 inner for ``w_xz``; the kv columns do not
        read it); None where the rank holds one contiguous range."""
        rank = self.tp.rank if rank is None else rank
        if name in _KV and self._gqa:
            return _kv_columns(self.cfg, rank, self.tp.size)
        if name == "w_xz":
            return _xz_columns(length, rank, self.tp.size)
        return None

    def split(self, x, axis: int, name: str, rank=None):
        """This rank's (or ``rank``'s) slice of ``x`` along ``axis``, in
        fresh memory: a view would keep the whole tensor alive (a
        leading-axis ``narrow`` is contiguous already)."""
        rank = self.tp.rank if rank is None else rank
        idx = self.index(name, x.shape[axis], rank)
        if idx is not None:
            return x.index_select(axis, idx.to(x.device))
        w = x.shape[axis] // self.tp.size
        return x.narrow(axis, rank * w, w).clone(
            memory_format=torch.contiguous_format)

    def join(self, parts, axis: int, name: str):
        """Inverse of ``split``: every rank's slice (in rank order) put
        back into the full tensor (a duplicated kv head is read from any
        rank that holds it: they are equal)."""
        cat = torch.cat(parts, dim=axis)
        n = cat.shape[axis]
        idx = [self.index(name, n, r) for r in range(self.tp.size)]
        if idx[0] is None:
            return cat
        idx = torch.cat(idx).to(cat.device)
        full_len = int(idx.max()) + 1
        shape = list(cat.shape)
        shape[axis] = full_len
        full = cat.new_zeros(shape)
        full.index_copy_(axis, idx, cat)
        return full

    # -- base params -------------------------------------------------------
    def shard_module(self, module: nn.Module) -> nn.Module:
        """A new module of the same class and tree whose split parameters
        are this rank's slices (fresh memory) and whose replicated ones
        are shared with ``module``."""
        new = module.__class__.__new__(module.__class__)
        nn.Module.__init__(new)
        for name, p in module.named_parameters(recurse=False):
            axis = self.axis(name)
            if axis is not None:
                p = nn.Parameter(self.split(p.detach(), axis, name),
                                 requires_grad=False)
            new.register_parameter(name, p)
        for name, child in module.named_children():
            new.add_module(name, self.shard_module(child))
        return new

    def shard_params(self, params: nn.Module) -> nn.Module:
        """This rank's slice of a full model (left as it is); a model that
        ``models.model.init_params(tp=...)`` made as this rank's slice is
        returned as it is."""
        key = (self.tp.rank, self.tp.size)
        held = getattr(params, "tp_shard", None)
        if held == key:
            return params
        if held is not None:
            raise ValueError(f"params are rank/size {held}'s slice, the "
                             f"engine is rank/size {key}")
        new = self.shard_module(params)
        new.tp_shard = key
        return new

    # -- LoRA banks ----------------------------------------------------------
    def _b_name(self, target: str) -> str:
        """The projection whose column split a target's B takes: the kv
        heads' for GQA's k and v, one even range for every other (MLA's k
        and v add to the replicated latent and are gathered)."""
        return {"k": "wk", "v": "wv"}.get(target, "") \
            if self.cfg.mla is None else ""

    def shard_adapter(self, weights):
        """One adapter's full-width ``{target: {"A": (..., d_in, r), "B":
        (..., r, d_out)}}`` (a bank's data, or a peer's weights) -> this
        rank's co-sharded slices."""
        return {t: {"A": self.split(w["A"], w["A"].dim() - 2, ""),
                    "B": self.split(w["B"], w["B"].dim() - 1,
                                    self._b_name(t))}
                for t, w in weights.items()}

    def shard_bank(self, bank: LoRABank) -> LoRABank:
        """The bank with this rank's co-sharded A/B slices."""
        data = tuple(self.shard_adapter(d) for d in bank.data) \
            if isinstance(bank.data, tuple) else self.shard_adapter(bank.data)
        return dataclasses.replace(bank, data=data)

    def gather_adapter(self, weights):
        """Inverse of ``shard_adapter``: every rank's slices put back
        together (a collective: every rank calls it)."""
        def gather(x, axis, name):
            x = x.contiguous()
            parts = [torch.empty_like(x) for _ in range(self.tp.size)]
            dist.all_gather(parts, x, group=self.tp.group)
            return self.join(parts, axis, name)
        return {t: {"A": gather(w["A"], w["A"].dim() - 2, ""),
                    "B": gather(w["B"], w["B"].dim() - 1, self._b_name(t))}
                for t, w in weights.items()}


def make_engine_sharding(tp, cfg):
    """None-propagating factory: no ``TensorParallel``, or one of size 1,
    means the single-device engine, exactly."""
    if tp is None or tp.size == 1:
        return None
    return EngineSharding(tp, cfg)
