"""Train steps of the PyTorch port, the JAX package's
``training/train_step.py``: full-parameter pretraining and LoRA-only
fine-tuning (frozen base + one adapter, the workload that *produces* the
adapters the serving system multiplexes).

Gradients come from autograd over the leaves a step trains, on
``models.model.forward``'s plain path (einsum LoRA, the plain flash
attention): no kernel of the port has a backward, and every kernel
wrapper refuses an input that requires grad. A leaf the loss never
reaches gets a zero gradient, as ``jax.value_and_grad`` gives it (autograd
gives None), so AdamW sees what the reference sees: its weight decay
still moves such a leaf.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import model as M
from repro_torch.models.common import chunked_cross_entropy

from .optimizer import (AdamWConfig, adamw_init, adamw_update, tree_leaves,
                        tree_map)


def _value_and_grad(loss_of, leaves):
    """(loss, grads shaped as ``leaves``): autograd of ``loss_of()`` over
    the tensors of ``leaves``, which require grad; zeros where the loss
    never reaches a leaf."""
    flat = tree_leaves(leaves)
    with torch.enable_grad():
        loss = loss_of()
        # a loss that reaches no leaf (the VLM's adapter) has no graph
        gs = torch.autograd.grad(loss, flat, allow_unused=True) \
            if loss.requires_grad else [None] * len(flat)
    by_id = {id(t): g for t, g in zip(flat, gs)}
    grads = tree_map(lambda t: torch.zeros_like(t) if by_id[id(t)] is None
                     else by_id[id(t)], leaves)
    return loss.detach(), grads


def make_train_step(cfg, opt_cfg: AdamWConfig, remat: bool = True):
    """Full-parameter train step: (params, opt_state, batch) -> (params,
    opt_state, metrics {loss, grad_norm, lr}). batch: {tokens, labels[,
    frontend]}, tensors on the parameters' device. ``params`` is the
    port's model (``models.model.init_params``); the step writes the
    updated values into its parameters and returns it (the JAX step
    returns new arrays), its parameters frozen again (``requires_grad``
    False, as the port makes them). ``opt_state`` is keyed by
    ``named_parameters()``."""

    def step(params, opt_state, batch):
        named = dict(params.named_parameters())
        for p in named.values():
            p.requires_grad_(True)
        try:
            loss, grads = _value_and_grad(
                lambda: M.loss_fn(cfg, params, batch, remat=remat), named)
        finally:
            # back to the frozen weights that serving and the kernels take
            for p in named.values():
                p.requires_grad_(False)
        new, opt_state, om = adamw_update(opt_cfg, grads, opt_state, named)
        del grads
        with torch.no_grad():
            for k, p in named.items():
                p.copy_(new[k])
        return params, opt_state, {"loss": loss, **om}

    return step


def make_lora_train_step(cfg, opt_cfg: AdamWConfig, remat: bool = True,
                         scaling: float = 1.0):
    """LoRA fine-tune step: (adapter, opt_state, params, batch) ->
    (adapter, opt_state, metrics), the base ``params`` frozen and
    untouched, a new adapter returned. adapter: {target: {"A": (L, d, r),
    "B": (L, r, out)}} (``lora.adapter.init_adapter``), run as the
    reference's one-adapter bank (``adapter[:, None]``, every row's index
    0) through the einsum LoRA path. ``scaling`` is taken and not used,
    as in the reference."""

    def loss(adapter, params, batch):
        bank = tree_map(lambda t: t[:, None], adapter)         # Na = 1
        tokens = batch["tokens"]
        idx = torch.zeros(tokens.shape[0], dtype=torch.int32,
                          device=tokens.device)
        h, aux = M.forward(cfg, params, tokens,
                           frontend=batch.get("frontend"), bank=bank,
                           lora_idx=idx, remat=remat)
        return chunked_cross_entropy(h, M.lm_head(cfg, params),
                                     batch["labels"]) + 0.01 * aux

    def step(adapter, opt_state, params, batch):
        leaves = tree_map(lambda t: t.detach().requires_grad_(True),
                          adapter)
        l, grads = _value_and_grad(lambda: loss(leaves, params, batch),
                                   leaves)
        adapter, opt_state, om = adamw_update(opt_cfg, grads, opt_state,
                                              adapter)
        return adapter, opt_state, {"loss": l, **om}

    return step


def init_train_state(cfg, seed: int = 0,
                     opt_cfg: Optional[AdamWConfig] = None,
                     dtype=torch.float32, device="cuda"):
    """(params, opt_state): the port's model from ``seed`` on ``device``
    and its AdamW state."""
    params = M.init_params(cfg, seed, dtype=dtype, device=device)
    return params, adamw_init(params)
