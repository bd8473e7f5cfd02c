"""Base and adapter weights made from the seed, on the device, in the type
they are served in, one large draw a leaf stacked over the layers. Both
the program and the reference read these same tensors.
"""
from __future__ import annotations

import torch


def _draw(shape, init, gen, device, dtype):
    t = torch.randn(shape, generator=gen, device=device, dtype=dtype)
    if init == "norm":
        return t.mul_(0.1).add_(1.0)
    if init == "bias":
        return t.mul_(0.02)
    return t.mul_(float(init) ** -0.5)


def base_weights(specs, seed: int, device, dtype) -> dict:
    """{name: tensor} for ``specs`` [(name, shape, init)] (an
    architecture's ``weight_specs``), from one generator seeded with
    ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return {name: _draw(shape, init, gen, device, dtype)
            for name, shape, init in specs}


def adapter_weights(ads, lora_dims: dict, n_layers: int, seed: int, device,
                    dtype) -> dict:
    """{adapter_id: {target: {"A": (L, d_in, r), "B": (L, r, d_out)}}}
    for ``ads`` [(adapter_id, rank, share)]: A ~ N(0, 1/d_in), B ~ N(0,
    0.25/r), the adapters of one rank drawn together a target."""
    gen = torch.Generator(device=device).manual_seed(seed ^ 0x5EED)
    by_rank = {}
    for aid, rank, _ in ads:
        by_rank.setdefault(rank, []).append(aid)
    out = {aid: {} for aid, _, _ in ads}
    for rank, ids in sorted(by_rank.items()):
        for t, (din, dout) in lora_dims.items():
            a = _draw((len(ids), n_layers, din, rank), din, gen, device,
                      dtype)
            b = _draw((len(ids), n_layers, rank, dout), 4 * rank, gen,
                      device, dtype)
            for j, aid in enumerate(ids):
                out[aid][t] = {"A": a[j], "B": b[j]}
    return out
