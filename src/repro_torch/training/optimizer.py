"""AdamW of the PyTorch port, the JAX package's ``training/optimizer.py``:
decoupled weight decay and global-norm gradient clipping over trees of
tensors (nested dicts, lists or tuples, as the JAX pytrees; or a
module's ``named_parameters()`` dict), the moments in fp32 whatever the
parameters' type.

Plain functions on tensors, in the reference's order of operations:
the clip scale from the fp32 global norm, fp32 moments, the bias
corrections, the decay inside the ``lr ·`` term, the result cast to the
parameter's type. ``torch.optim.AdamW`` rounds in an order of its own
and takes no mask, so it is not used.
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the same leaves of ``rest``
    (trees of the same structure), keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree):
    """The leaves in the JAX order: dict keys sorted, sequences in
    order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def lr_schedule(cfg: AdamWConfig, step):
    """Linear warmup + cosine decay; ``step`` an int tensor, the rate an
    fp32 tensor."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(1, cfg.warmup_steps), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps) /
                       max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * \
        0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * cos


def adamw_init(params):
    """{"mu", "nu": fp32 zeros shaped as ``params``, "step": int32 0} on
    the parameters' device. A module stands for its
    ``named_parameters()`` dict."""
    if isinstance(params, torch.nn.Module):
        params = dict(params.named_parameters())

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    dev = tree_leaves(params)[0].device
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree):
    """sqrt of the sum over leaves of each leaf's fp32 sum of squares."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def _unzip(tree, out, i):
    """Item ``i`` of each leaf's (param, mu, nu) in ``out``, shaped as
    ``tree``."""
    if isinstance(tree, dict):
        return {k: _unzip(tree[k], out[k], i) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unzip(t, o, i) for t, o in zip(tree, out))
    return out[i]


def adamw_update(cfg: AdamWConfig, grads, opt_state, params,
                 trainable_mask=None):
    """Returns (new_params, new_opt_state, metrics {grad_norm, lr}), new
    tensors (the inputs are not written). ``trainable_mask``: an optional
    tree of bools; a frozen leaf passes through unchanged, its moments
    too (LoRA-only fine-tuning of a frozen base)."""
    with torch.no_grad():
        step = opt_state["step"] + 1
        gn = global_norm(grads)
        scale = torch.clamp(cfg.clip_norm / (gn + 1e-9), max=1.0)
        lr = lr_schedule(cfg, step)
        b1c = 1 - cfg.b1 ** step.to(torch.float32)
        b2c = 1 - cfg.b2 ** step.to(torch.float32)
        if trainable_mask is None:
            trainable_mask = tree_map(lambda _: True, params)

        def upd(p, g, mu, nu, t):
            if not t:
                return p, mu, nu
            g32 = g.float() * scale
            mu2 = cfg.b1 * mu + (1 - cfg.b1) * g32
            nu2 = cfg.b2 * nu + (1 - cfg.b2) * g32 * g32
            mhat = mu2 / b1c
            nhat = nu2 / b2c
            delta = lr * (mhat / (torch.sqrt(nhat) + cfg.eps)
                          + cfg.weight_decay * p.float())
            return (p.float() - delta).to(p.dtype), mu2, nu2

        out = tree_map(upd, params, grads, opt_state["mu"], opt_state["nu"],
                       trainable_mask)
        new_state = {"mu": _unzip(params, out, 1),
                     "nu": _unzip(params, out, 2), "step": step}
    return _unzip(params, out, 0), new_state, {"grad_norm": gn, "lr": lr}
