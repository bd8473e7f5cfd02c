"""Tensor-parallel serving: the sharding layer of the engine's ``mesh=``
mode (the counterpart of the JAX package's ``serving/sharding.py`` with
dp = 1).

``EngineSharding`` binds one rank's ``TensorParallel`` to an engine and
owns every placement decision:

* base params — Megatron layout: ``wq wk wv w1 w3`` (and the q/k/v
  biases) column-parallel, ``wo w2`` row-parallel, each rank a
  contiguous range of heads and of d_ff; embed, the norms and
  ``lm_head`` replicated (a placement choice; no number changes);
* KV cache — kv-head sharded (the JAX package's "baseline" layout,
  ``launch/specs.py:94``): ``models.model.init_cache(tp=...)`` makes the
  rank's slice directly;
* LoRA banks — co-sharded: every bucket's A split along d_in, its B
  along d_out, so the kernels run on the rank's slices and one
  all-reduce of the rank-r intermediate joins them
  (``lora.batched``).

Where the JAX package falls back to replicating a dim that the mesh
does not divide (``fit_spec``), this one refuses the config; it refuses
MoE and MLA configs too (ROADMAP queue A item 9).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch import nn

from repro_torch.launch.mesh import TensorParallel
from repro_torch.lora.bank import LoRABank

# parameter name -> the axis a rank slices (1: column-parallel, 0:
# row-parallel); every other parameter is replicated
PARAM_SPLIT = {"wq": 1, "wk": 1, "wv": 1, "w1": 1, "w3": 1,
               "bq": 0, "bk": 0, "bv": 0, "wo": 0, "w2": 0}


def _slice(x, axis: int, tp: TensorParallel):
    w = x.shape[axis] // tp.size
    return x.narrow(axis, tp.rank * w, w)


def _rebuild(module: nn.Module, tp: TensorParallel) -> nn.Module:
    """A new module of the same class and tree whose split parameters are
    this rank's contiguous slices (fresh memory) and whose replicated ones
    are shared with ``module``."""
    new = module.__class__.__new__(module.__class__)
    nn.Module.__init__(new)
    for name, p in module.named_parameters(recurse=False):
        if name in PARAM_SPLIT:
            p = nn.Parameter(_slice(p.detach(), PARAM_SPLIT[name],
                                    tp).contiguous(), requires_grad=False)
        new.register_parameter(name, p)
    for name, child in module.named_children():
        new.add_module(name, _rebuild(child, tp))
    return new


class EngineSharding:
    """Placement for one rank of a tensor-parallel engine."""

    def __init__(self, tp: TensorParallel, cfg):
        if cfg.moe is not None or cfg.mla is not None:
            raise NotImplementedError(
                f"{cfg.name}: MoE and MLA layers are not sharded at tp > 1; "
                "the port shards the dense layout only (PARAM_SPLIT). "
                "Expert parallelism (moe_ffn_ep) and MLA's head split are "
                "ROADMAP queue A item 9")
        for name in ("n_heads", "n_kv_heads", "d_ff", "d_model"):
            if getattr(cfg, name) % tp.size:
                raise ValueError(
                    f"{cfg.name}: {name}={getattr(cfg, name)} is not "
                    f"divisible by tp={tp.size}")
        self.tp = tp

    def shard_params(self, params: nn.Module) -> nn.Module:
        """This rank's slice of a full ``DenseLM`` (left as it is)."""
        return _rebuild(params, self.tp)

    def shard_adapter(self, weights):
        """One adapter's full-width ``{target: {"A": (..., d_in, r), "B":
        (..., r, d_out)}}`` (a bank's data, or a peer's weights) -> this
        rank's co-sharded slices."""
        return {t: {"A": _slice(w["A"], -2, self.tp).contiguous(),
                    "B": _slice(w["B"], -1, self.tp).contiguous()}
                for t, w in weights.items()}

    def shard_bank(self, bank: LoRABank) -> LoRABank:
        """The bank with this rank's co-sharded A/B slices."""
        data = tuple(self.shard_adapter(d) for d in bank.data) \
            if isinstance(bank.data, tuple) else self.shard_adapter(bank.data)
        return dataclasses.replace(bank, data=data)

    def gather_adapter(self, weights):
        """Inverse of ``shard_adapter``: every rank's slices put side by
        side (a collective: every rank calls it)."""
        def gather(x, axis):
            parts = [torch.empty_like(x) for _ in range(self.tp.size)]
            dist.all_gather(parts, x.contiguous(), group=self.tp.group)
            return torch.cat(parts, dim=axis)
        return {t: {"A": gather(w["A"], -2), "B": gather(w["B"], -1)}
                for t, w in weights.items()}


def make_engine_sharding(tp, cfg):
    """None-propagating factory: no ``TensorParallel``, or one of size 1,
    means the single-device engine, exactly."""
    if tp is None or tp.size == 1:
        return None
    return EngineSharding(tp, cfg)
