"""Production-like trace matching the paper's Company X characterization:

  * 5 base production adapters of distinct ranks with the rank-wise
    request/token shares of Fig 15;
  * heavy-tailed adapter popularity: top-5 adapters > 70% of traffic
    (Fig 8), the long tail gets the rest;
  * per-adapter arrival drift: varying-load, diurnal, stable, and
    late-surge patterns (Fig 10);
  * annotated into 50/100/200 total adapters via a power law (alpha=1)
    within each rank (§V-E).
"""
from __future__ import annotations

import math
import random
from typing import List, Optional

from repro_torch.core.types import AdapterInfo
from repro_torch.cluster.server import SimRequest

from .synth import make_adapters

# Fig 15 rank-wise request share of the production trace (normalized).
RANK_REQUEST_SHARE = {8: 0.38, 16: 0.27, 32: 0.18, 64: 0.11, 128: 0.06}
# Fig 8: top-5 adapters take ~72.4% of traffic.
TOP5_SHARE = 0.724


def _drift(pattern: str, progress: float) -> float:
    """Relative intensity multiplier over the trace (Fig 10 shapes)."""
    if pattern == "rising":
        return 0.5 + 1.0 * progress
    if pattern == "falling":
        return 1.5 - 1.0 * progress
    if pattern == "diurnal":
        return 1.0 + 0.6 * math.sin(2 * math.pi * progress)
    if pattern == "stable":
        return 1.0
    if pattern == "surge":
        return 1.0 if progress < 0.8 else 3.0
    return 1.0


def production_trace(n_adapters: int, rps: float, duration: float,
                     prompt_len: int = 512, output_len: int = 128,
                     seed: int = 0,
                     load_profile: Optional[str] = None) -> List[SimRequest]:
    reqs, _ = production_trace_with_meta(
        n_adapters, rps, duration, prompt_len=prompt_len,
        output_len=output_len, seed=seed, load_profile=load_profile)
    return reqs


def production_trace_with_meta(n_adapters: int, rps: float,
                               duration: float, prompt_len: int = 512,
                               output_len: int = 128, seed: int = 0,
                               load_profile: Optional[str] = None):
    """Like :func:`production_trace` but also returns the generator's
    ground truth: the per-adapter drift-pattern assignment (adapter_id
    -> Fig 10 pattern; tail adapters are "stable") so drift detectors
    can be validated against what the trace actually does, plus the
    aggregate load profile. ``load_profile`` optionally modulates the
    *aggregate* arrival rate with one of the ``_drift`` shapes (e.g.
    "diurnal" for the day-night swing autoscaling exploits) via
    Poisson thinning."""
    rng = random.Random(seed)
    adapters = make_adapters(n_adapters, seed=seed)
    by_rank = {}
    for a in adapters:
        by_rank.setdefault(a.rank, []).append(a)

    # top-5: most popular adapter of each rank, drifting per Fig 10
    top5 = [by_rank[r][0] for r in sorted(by_rank)]
    drifts = ["rising", "falling", "diurnal", "stable", "surge"]
    patterns = {a.adapter_id: "stable" for a in adapters}
    for j, a in enumerate(top5):
        patterns[a.adapter_id] = drifts[j % len(drifts)]

    ranks = sorted(RANK_REQUEST_SHARE)

    def rank_weights(progress: float) -> List[float]:
        """Fig 15 rank share scaled by each rank-head's Fig 10 drift:
        a surging adapter *adds* arrival intensity instead of merely
        shifting within-rank share, so its absolute rate really surges
        while stable adapters stay stable (the detector ground truth)."""
        return [RANK_REQUEST_SHARE[r]
                * ((1 - TOP5_SHARE) + TOP5_SHARE
                   * _drift(patterns[by_rank[r][0].adapter_id], progress))
                for r in ranks]

    def load(progress: float) -> float:
        return _drift(load_profile, progress) if load_profile else 1.0

    # thinning peaks (drift shapes are bounded, 3x at most)
    grid = [p / 100.0 for p in range(101)]
    peak_i = max(sum(rank_weights(p)) for p in grid)
    peak_l = max(load(p) for p in grid)

    reqs: List[SimRequest] = []
    t, i = 0.0, 0
    while t < duration:
        t += rng.expovariate(rps * peak_i * peak_l)
        if t >= duration:
            break
        progress = t / duration
        rw = rank_weights(progress)
        accept = (sum(rw) / peak_i) * (load(progress) / peak_l)
        if rng.random() >= accept:
            continue    # thinned: instantaneous intensity below peak
        rank = rng.choices(ranks, weights=rw)[0]
        pool = by_rank[rank]
        head = pool[0]
        head_idx = top5.index(head) if head in top5 else 0
        head_w = TOP5_SHARE * _drift(drifts[head_idx % len(drifts)],
                                     progress)
        tail_w = (1 - TOP5_SHARE)
        if len(pool) == 1 or rng.random() < head_w / (head_w + tail_w):
            a = head
        else:
            tail = pool[1:]
            aw = [(j + 1) ** (-1.0) for j in range(len(tail))]
            a = rng.choices(tail, weights=aw)[0]
        pl = max(16, int(rng.lognormvariate(math.log(prompt_len), 0.4)))
        ol = max(4, int(rng.lognormvariate(math.log(output_len), 0.4)))
        reqs.append(SimRequest(req_id=i, adapter_id=a.adapter_id, rank=rank,
                               prompt_len=pl, output_len=ol, arrival=t))
        i += 1
    meta = {"patterns": patterns, "adapters": adapters,
            "load_profile": load_profile or "flat"}
    return reqs, meta


def production_adapters(n_adapters: int, seed: int = 0):
    return make_adapters(n_adapters, seed=seed)
