"""A copy of the JAX package's ``traces/synth.py``.

Trace generators matching the paper's evaluation traces (§V-E).

Dimensions:
  * arrival pattern: uniform or Poisson;
  * adapter-rank popularity: uniform, shifting-skew (Fig 16), exponential,
    or power-law with exponent alpha (Fig 22);
  * adapter counts per rank: power law (alpha=1) within rank, as the paper
    annotates its production trace.

Requests carry (adapter, prompt_len, output_len, timestamp). Default
lengths follow the paper's Fig 6 workload (input 512 / output 128) with
lognormal jitter.
"""
from __future__ import annotations

import math
import random
from typing import Dict, List, Optional, Sequence

from repro_torch.core.types import AdapterInfo
from repro_torch.cluster.server import SimRequest

DEFAULT_RANKS = (8, 16, 32, 64, 128)


def make_adapters(n_adapters: int, ranks: Sequence[int] = DEFAULT_RANKS,
                  nbytes_per_rank: Optional[Dict[int, int]] = None,
                  alpha: float = 1.0, seed: int = 0) -> List[AdapterInfo]:
    """Split `n_adapters` across ranks following a power law on counts
    (alpha=1 as in §V-E), rank order ascending in popularity count."""
    weights = [(i + 1) ** (-alpha) for i in range(len(ranks))]
    tot = sum(weights)
    counts = [max(1, round(n_adapters * w / tot)) for w in weights]
    while sum(counts) > n_adapters:
        counts[counts.index(max(counts))] -= 1
    while sum(counts) < n_adapters:
        counts[counts.index(min(counts))] += 1
    out = []
    for rank, cnt in zip(ranks, counts):
        for i in range(cnt):
            nbytes = (nbytes_per_rank or {}).get(
                rank, 2 * 4 * 2 * 4096 * rank * 32)   # qkvo A+B, 32L, bf16
            out.append(AdapterInfo(f"r{rank}-a{i}", rank, nbytes))
    return out


def _arrivals(rps: float, duration: float, pattern: str, rng) -> List[float]:
    out = []
    if pattern == "uniform":
        n = int(rps * duration)
        out = [i / rps for i in range(n)]
    elif pattern == "poisson":
        t = 0.0
        while t < duration:
            t += rng.expovariate(rps)
            if t < duration:
                out.append(t)
    else:
        raise ValueError(pattern)
    return out


def _rank_weights(popularity: str, ranks: Sequence[int], progress: float,
                  alpha: float = 1.0) -> List[float]:
    n = len(ranks)
    if popularity == "uniform":
        return [1.0 / n] * n
    if popularity == "exponential":
        w = [math.exp(-i) for i in range(n)]          # small ranks popular
        tot = sum(w)
        return [x / tot for x in w]
    if popularity == "powerlaw":
        w = [(i + 1) ** (-alpha) for i in range(n)]   # ranks ascending
        tot = sum(w)
        return [x / tot for x in w]
    if popularity == "shifting":
        # Fig 16: starts with rank-max at 50%, ends with rank-min at 50%
        hi = [0.5 / (n - 1)] * n
        hi[-1] = 0.5
        lo = [0.5 / (n - 1)] * n
        lo[0] = 0.5
        return [h * (1 - progress) + l * progress for h, l in zip(hi, lo)]
    raise ValueError(popularity)


def synth_trace(adapters: List[AdapterInfo], rps: float, duration: float,
                arrival: str = "poisson", popularity: str = "uniform",
                alpha: float = 1.0, prompt_len: int = 512,
                output_len: int = 128, jitter: float = 0.3,
                seed: int = 0) -> List[SimRequest]:
    rng = random.Random(seed)
    by_rank: Dict[int, List[AdapterInfo]] = {}
    for a in adapters:
        by_rank.setdefault(a.rank, []).append(a)
    ranks = sorted(by_rank)
    times = _arrivals(rps, duration, arrival, rng)
    reqs = []
    for i, t in enumerate(times):
        w = _rank_weights(popularity, ranks, t / duration, alpha)
        rank = rng.choices(ranks, weights=w)[0]
        # within a rank: power-law adapter popularity (alpha=1)
        pool = by_rank[rank]
        aw = [(j + 1) ** (-1.0) for j in range(len(pool))]
        a = rng.choices(pool, weights=aw)[0]
        pl = max(16, int(rng.lognormvariate(math.log(prompt_len), jitter)))
        ol = max(4, int(rng.lognormvariate(math.log(output_len), jitter)))
        reqs.append(SimRequest(req_id=i, adapter_id=a.adapter_id,
                               rank=rank, prompt_len=pl, output_len=ol,
                               arrival=t))
    return reqs


def six_traces(adapters, rps: float, duration: float, seed: int = 0):
    """The paper's 2 arrival x 3 popularity grid (§V-E)."""
    out = {}
    for arrival in ("uniform", "poisson"):
        for pop in ("uniform", "shifting", "exponential"):
            out[f"{arrival}-{pop}"] = synth_trace(
                adapters, rps, duration, arrival=arrival, popularity=pop,
                seed=seed)
    return out
