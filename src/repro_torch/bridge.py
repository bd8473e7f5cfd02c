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
from repro_torch.models.model import DenseLM, init_params
from repro_torch.serving.sharding import PARAM_SPLIT


def _t(a, device, dtype=None):
    t = torch.from_numpy(np.array(a)).to(device)        # a writable copy
    return t if dtype is None else t.to(dtype)


def params_from_numpy(cfg, tree, *, device="cuda",
                      dtype=torch.float32) -> DenseLM:
    """The JAX param tree of ``models/model.py:init_params`` (blocks
    stacked on a leading layer axis), as numpy arrays -> a ``DenseLM``
    (dense or MoE, GQA or MLA: the module attributes carry the JAX leaves'
    names)."""
    dev = resolve_device(device)
    lm = init_params(cfg, 0, dtype=dtype, device=dev)   # then overwritten
    with torch.no_grad():
        lm.embed.copy_(_t(tree["embed"], dev, dtype))
        lm.ln_f.copy_(_t(tree["ln_f"], dev, dtype))
        if not cfg.tie_embeddings:
            lm.lm_head.copy_(_t(tree["lm_head"], dev, dtype))
        blocks = tree["blocks"]
        for i, bp in enumerate(lm.blocks):
            bp.ln1.copy_(_t(blocks["ln1"][i], dev, dtype))
            bp.ln2.copy_(_t(blocks["ln2"][i], dev, dtype))
            # each leaf in its parameter's own type: the MoE router stays
            # fp32 whatever ``dtype``
            for sub in ("attn", "ffn"):
                for name, p in getattr(bp, sub).named_parameters():
                    p.copy_(_t(blocks[sub][name][i], dev, p.dtype))
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


def check_shards(full: DenseLM, shards) -> None:
    """Raise unless the ranks' sliced modules put ``full`` back together:
    ``shards`` holds each rank's ``{name: tensor or array}`` (its
    ``named_parameters()``), in rank order. Split parameters are joined
    along their axis (``serving.sharding.PARAM_SPLIT``); replicated ones
    must equal the full module's on every rank."""
    for name, want in full.named_parameters():
        parts = [torch.as_tensor(sh[name]) for sh in shards]
        axis = PARAM_SPLIT.get(name.rsplit(".", 1)[-1])
        for g in parts if axis is None else [torch.cat(parts, dim=axis)]:
            if not torch.equal(g.to(want.device, want.dtype), want.detach()):
                raise ValueError(f"{name}: the ranks' slices do not put "
                                 "the full parameter back together")


def adapter_weights_from_numpy(w, *, device="cpu", dtype=None):
    """One adapter's ``{target: {"A": (L, d, r), "B": (L, r, o)}}`` numpy
    weights -> tensors, in the form ``ServingEngine.install_adapter``
    and ``LoRABank.set_adapter`` take. They stay on the host by default:
    installing copies them to the bank's device."""
    return _bank_tree(w, resolve_device(device), dtype)
