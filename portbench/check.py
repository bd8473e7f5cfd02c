"""The check of what the window served, against the plain reference.

Once the window has closed and the program's state is freed, a sample of
the finished requests, drawn from the seed, is run through the reference
(float32, ``portbench/arch/<model_type>_ref.py``) once each: the prompt
and the served tokens, teacher-forced. At every served position the gap
is the reference's best logit less the logit of the token the program
served (0 where they agree). The number compared is the widest gap over
the sample, against the cell's limit (``cells/<workload>.json``,
``check.max_gap``). The sample always holds the request with the most
served tokens and one of every adapter rank among the finished, then more
in the seed's order until it holds ``check.sample_tokens`` served tokens.

Served tokens are greedy, so they are the program's argmax; the first of
each request comes from the prefill's logits and the rest from decode
steps through the cache, across every layer, the adapters' deltas and the
float32 head.

With ``control``, the reference also runs on its weights rounded to
float8 (``ref_common.quantize``), and at the same positions the gap of
the token that this lower precision puts first is read the same way: the
control's widest gap, which the limit has to fail.
"""
from __future__ import annotations

import random

import torch


def sample(finished, seed: int, want_tokens: int):
    """The finished records to check, in a fixed order."""
    rng = random.Random(seed ^ 0xC0FFEE)
    pool = sorted(finished, key=lambda r: r.req.req_id)
    rng.shuffle(pool)
    if not pool:
        return []
    longest = max(pool, key=lambda r: (len(r.req.output), -r.req.req_id))
    picked = [longest]
    for rank in sorted({r.rank for r in pool}):
        if rank != longest.rank:
            picked.append(next(r for r in pool if r.rank == rank))
    for r in pool:
        if sum(len(p.req.output) for p in picked) >= want_tokens:
            break
        if r not in picked:
            picked.append(r)
    return picked


def gaps(ref, c: dict, w: dict, aw: dict, rec, control: bool):
    """(program's gaps, control's gaps or None) at the served positions
    of one request."""
    req = rec.req
    dev = w["embed"].device
    seq = torch.tensor(list(req.prompt) + list(req.output[:-1]),
                       dtype=torch.long, device=dev)
    p = len(req.prompt)
    pos = torch.arange(p - 1, p - 1 + len(req.output), device=dev)
    served = torch.tensor(req.output, dtype=torch.long, device=dev)
    with torch.no_grad():
        lg = ref.forward(c, w, seq, aw[req.adapter_id], pos)
        best = lg.max(dim=-1).values
        mine = best - lg.gather(1, served[:, None])[:, 0]
        if not control:
            return mine, None
        low = ref.forward(c, w, seq, aw[req.adapter_id], pos, control=True)
        theirs = best - lg.gather(1, low.argmax(-1, keepdim=True))[:, 0]
    return mine, theirs


def compare(cell, ref, w: dict, aw: dict, finished, seed: int,
            control: bool = False) -> dict:
    """{name: {"value", "limit"}}: the statistic (at most its limit) and
    the served tokens checked (at least 1); with ``control`` also the
    control's statistic against the same limit, and ``readings``, a
    summary of both sides' gaps."""
    chk = cell.engine["check"]
    stat = chk["statistic"]
    picked = sample(finished, seed, chk["sample_tokens"])
    mine, theirs = [], []
    for rec in picked:
        m, t = gaps(ref, cell.config, w, aw, rec, control)
        mine.append(m)
        theirs.append(t)
    mine = torch.cat(mine) if mine else torch.zeros(0)
    out = {"served_tokens": {"value": mine.numel(), "limit": 1},
           stat: {"value": STATS[stat](mine), "limit": chk["limit"]}}
    if control:
        theirs = torch.cat(theirs)
        out["control_" + stat] = {"value": STATS[stat](theirs),
                                  "limit": chk["limit"]}
        out["readings"] = {who: summary(g) for who, g in
                           (("program", mine), ("control", theirs))}
    return out


STATS = {"widest_gap": lambda g: float(g.max()) if g.numel() else 0.0,
         "mean_gap": lambda g: float(g.mean()) if g.numel() else 0.0}


def summary(g) -> dict:
    """The calibration's look at a run's gaps: quantiles, mean and the
    share of positions where the token is not the reference's best."""
    g = g.double().cpu()
    q = torch.quantile(g, torch.tensor([0.5, 0.9, 0.99, 0.999],
                                       dtype=torch.double)).tolist()
    return {"n": g.numel(), "max": float(g.max()), "mean": float(g.mean()),
            "q50_90_99_999": q, "share_not_best": float((g > 0).double()
                                                      .mean())}


def correct(compared: dict, stat: str) -> bool:
    """The run's outputs pass: the statistic within its limit, and some
    served tokens checked (a window that finished none has nothing to
    show)."""
    g = compared[stat]
    n = compared["served_tokens"]
    return g["limit"] is not None and g["value"] <= g["limit"] and \
        n["value"] >= n["limit"]
