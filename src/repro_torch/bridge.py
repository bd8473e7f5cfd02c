"""Carry weights and bank state from the JAX package to the port.

Everything comes in as numpy arrays, never as JAX arrays: the caller
converts (``jax.tree.map(np.asarray, tree)``), so this module imports no
JAX. The port's own ``init_params`` / ``build_bank`` draw from
``torch.Generator``s and give other numbers than JAX's PRNG; parity
tests therefore make weights once and bring them across here.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.lora.bank import LoRABank
from repro_torch.models.model import BaseLM, DenseLM, init_params
from repro_torch.launch.mesh import TensorParallel
from repro_torch.serving.sharding import PARAM_SPLIT, EngineSharding


def _t(a, device, dtype=None):
    t = torch.from_numpy(np.array(a)).to(device)        # a writable copy
    return t if dtype is None else t.to(dtype)


def _copy_leaves(module, tree, i=None):
    """Every parameter of ``module`` from the JAX subtree ``tree`` (a
    dotted parameter name is a path in it; ``i`` picks layer i of a tree
    stacked on a leading axis), each leaf in its parameter's own type: the
    MoE router stays fp32 whatever the model's."""
    for name, p in module.named_parameters():
        leaf = tree
        for key in name.split("."):
            leaf = leaf[key]
        p.copy_(_t(leaf if i is None else leaf[i], p.device, p.dtype))


def params_from_numpy(cfg, tree, *, device="cuda",
                      dtype=torch.float32) -> BaseLM:
    """The JAX param tree of ``models/model.py:init_params`` as numpy
    arrays -> the port's model of ``cfg.family``: a ``DenseLM`` (dense or
    MoE, GQA or MLA; ``blocks`` stacked on a leading layer axis), a
    ``HybridLM`` (``mamba_blocks`` stacked, one ``shared_attn``), an
    ``RWKVLM`` (``blocks`` stacked), a ``VisionLM`` (``self_blocks`` and
    ``cross_blocks`` stacked, each gate of shape (1,)) or an ``EncDecLM``
    (``enc_blocks`` and ``dec_blocks`` stacked, ``enc_ln_f``). The
    modules' attributes carry the JAX leaves' names."""
    dev = resolve_device(device)
    lm = init_params(cfg, 0, dtype=dtype, device=dev)   # then overwritten
    with torch.no_grad():
        for name, p in lm.named_parameters(recurse=False):
            p.copy_(_t(tree[name], dev, p.dtype))
        for name, child in lm.named_children():
            if isinstance(child, torch.nn.ModuleList):
                for i, block in enumerate(child):
                    _copy_leaves(block, tree[name], i)
            else:
                _copy_leaves(child, tree[name])
    return lm


def _bank_tree(tree, device, dtype):
    return {t: {k: _t(w[k], device, dtype) for k in ("A", "B")}
            for t, w in tree.items()}


def bank_from_numpy(cfg, fields, *, device="cuda", dtype=None) -> LoRABank:
    """The fields of a JAX ``LoRABank`` (``mode``, ``adapter_ids``,
    ``ranks``, ``data`` as numpy, ``bucket_ranks``, ``bucket_counts``,
    ``adapter_bucket``, ``adapter_local``) -> a port ``LoRABank``.
    ``dtype=None`` keeps the arrays' own type."""
    dev = resolve_device(device)
    if fields["mode"] == "padded":
        data = _bank_tree(fields["data"], dev, dtype)
    else:
        data = tuple(_bank_tree(d, dev, dtype) for d in fields["data"])
    idx = {}
    for k in ("adapter_bucket", "adapter_local"):
        if fields.get(k) is not None:
            idx[k] = _t(np.asarray(fields[k], np.int32), dev)
    return LoRABank(fields["mode"], tuple(fields["adapter_ids"]),
                    tuple(int(r) for r in fields["ranks"]), data,
                    bucket_ranks=tuple(fields.get("bucket_ranks", ())),
                    bucket_counts=tuple(fields.get("bucket_counts", ())),
                    **idx)


def check_shards(cfg, full: BaseLM, shards) -> None:
    """Raise unless the ranks' sliced modules put ``full`` back together:
    ``shards`` holds each rank's ``{name: tensor or array}`` (its
    ``named_parameters()``), in rank order. Split parameters are joined
    along their axis as ``serving.sharding.EngineSharding`` split them
    (``PARAM_SPLIT``; the regrouped kv heads and Mamba2's ``[x | z]``
    by their indices); replicated ones must equal the full module's on
    every rank."""
    layout = EngineSharding(TensorParallel(None, 0, len(shards)), cfg)
    for name, want in full.named_parameters():
        parts = [torch.as_tensor(sh[name]) for sh in shards]
        leaf = name.rsplit(".", 1)[-1]
        axis = PARAM_SPLIT.get(leaf)
        for g in parts if axis is None else [layout.join(parts, axis, leaf)]:
            if not torch.equal(g.to(want.device, want.dtype), want.detach()):
                raise ValueError(f"{name}: the ranks' slices do not put "
                                 "the full parameter back together")


def adapter_weights_from_numpy(w, *, device="cpu", dtype=None):
    """One adapter's ``{target: {"A": (L, d, r), "B": (L, r, o)}}`` numpy
    weights -> tensors, in the form ``ServingEngine.install_adapter``
    and ``LoRABank.set_adapter`` take. They stay on the host by default:
    installing copies them to the bank's device."""
    return _bank_tree(w, resolve_device(device), dtype)
