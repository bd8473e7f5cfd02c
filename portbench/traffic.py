"""The one generator of the benchmark's traffic, driven by a mix's data
file (``portbench/traffic/<name>.json``) and a seed.

Every seed gets the same set of sizes and adapters, in its own order:
lengths are the quantiles (i + 0.5) / n of their lognormal truncated to
[min, max], and adapters are dealt out by their shares (largest
remainder). So two seeds differ by the order of the work and by the
prompt tokens, not by how much work there is. The mixes are closed loops:
a client sends its next job when its last one has finished.

Adapters follow the production trace of the paper (a frozen copy of the
arithmetic of ``repro_torch/traces/production.py`` and
``traces/synth.py:make_adapters``, without the Fig 10 drift): the adapter
count split over ranks by a power law (alpha 1), request shares by rank
from Fig 15, and within each rank the head adapter takes ``top_share`` of
the rank's requests (Fig 8's top five) and the tail the rest by a power
law.
"""
from __future__ import annotations

import dataclasses
import math
import random
from statistics import NormalDist
from typing import List

import torch


@dataclasses.dataclass
class Job:
    """One request as the traffic makes it."""
    adapter_id: str
    rank: int
    prompt: List[int]
    output_len: int


def adapters(spec: dict):
    """[(adapter_id, rank, request share)] of the mix's adapters."""
    ranks = spec["ranks"]
    n = spec["count"]
    w = [(i + 1) ** -spec["alpha"] for i in range(len(ranks))]
    counts = [max(1, round(n * x / sum(w))) for x in w]
    while sum(counts) > n:
        counts[counts.index(max(counts))] -= 1
    while sum(counts) < n:
        counts[counts.index(min(counts))] += 1
    share = {int(k): v for k, v in spec["rank_request_share"].items()}
    top = spec["top_share"]
    out = []
    for rank, cnt in zip(ranks, counts):
        s = share[rank] / sum(share.values())
        tail = [(j + 1) ** -1.0 for j in range(cnt - 1)]
        for i in range(cnt):
            if cnt == 1:
                a = s
            elif i == 0:
                a = s * top
            else:
                a = s * (1 - top) * tail[i - 1] / sum(tail)
            out.append((f"r{rank}-a{i}", rank, a))
    return out


def quantiles(n: int):
    return [(i + 0.5) / n for i in range(n)]


def lengths(spec: dict, n: int, rng: random.Random) -> List[int]:
    """n lengths: the quantiles of lognormal(log median, sigma) truncated
    to [min, max], in the seed's order. Truncated, not clipped: a clip
    would pile the tail onto one length, and the engine prefills the
    prompts of one length as one group."""
    nd = NormalDist()
    lo, hi, med, sig = spec["min"], spec["max"], spec["median"], \
        spec["sigma"]
    f_lo, f_hi = (nd.cdf(math.log(x / med) / sig) for x in (lo, hi))
    out = [min(hi, max(lo, round(med * math.exp(
        sig * nd.inv_cdf(f_lo + u * (f_hi - f_lo))))))
        for u in quantiles(n)]
    rng.shuffle(out)
    return out


def deal(ads, n: int, rng: random.Random):
    """n adapters dealt by their shares (largest remainder), in the seed's
    order."""
    raw = [a[2] * n for a in ads]
    counts = [int(x) for x in raw]
    for i in sorted(range(len(ads)), key=lambda i: counts[i] - raw[i])[
            :n - sum(counts)]:
        counts[i] += 1
    out = [a[:2] for a, c in zip(ads, counts) for _ in range(c)]
    rng.shuffle(out)
    return out


def _tokens(n: int, vocab: int, gen: torch.Generator) -> List[int]:
    return torch.randint(1, vocab, (n,), generator=gen).tolist()


def make_jobs(mix: dict, n: int, vocab: int, seed: int) -> List[Job]:
    """n jobs of the mix: lengths, adapters and prompt tokens from
    ``seed``."""
    rng = random.Random(seed)
    gen = torch.Generator().manual_seed(seed)
    plens = lengths(mix["prompt"], n, rng)
    olens = lengths(mix["output"], n, rng)
    ads = deal(adapters(mix["adapters"]), n, rng)
    return [Job(aid, rank, _tokens(p, vocab, gen), o)
            for (aid, rank), p, o in zip(ads, plens, olens)]


def steady_start(mix: dict, n: int, vocab: int, seed: int) -> List[Job]:
    """The jobs of a closed loop's n clients as the loop in its steady
    state holds them: each with a share (i + 0.5) / n of its output still
    to run, so their completions and refills spread over the window from
    its start. Their prompt lengths, outputs and shares are paired the
    same way under every seed, so every seed opens on the same work; the
    seed deals the adapters and the tokens, and the order."""
    fixed = random.Random(0)
    plens = lengths(mix["prompt"], n, fixed)
    olens = lengths(mix["output"], n, fixed)
    left = quantiles(n)
    fixed.shuffle(left)
    rng = random.Random(seed + 1)
    gen = torch.Generator().manual_seed(seed + 1)
    ads = deal(adapters(mix["adapters"]), n, rng)
    jobs = [Job(aid, rank, _tokens(p, vocab, gen),
                max(1, math.ceil(u * o)))
            for (aid, rank), p, o, u in zip(ads, plens, olens, left)]
    rng.shuffle(jobs)
    return jobs
