"""Latency metrics: TTFT / TBT / adapter-fetch percentiles over finished
requests. A copy of the JAX package's ``serving/metrics.py``, so the port
imports nothing of ``repro``."""
from __future__ import annotations

from typing import List


def percentile(values: List[float], p: float) -> float:
    """Linear-interpolated percentile (numpy's default method). The old
    nearest-rank ``int(...)`` floor systematically under-reported high
    percentiles on small windows (P99 of 50 samples collapsed to the
    floor rank)."""
    if not values:
        return float("nan")
    vs = sorted(values)
    pos = min(len(vs) - 1.0, max(0.0, p / 100.0 * (len(vs) - 1)))
    lo = int(pos)
    frac = pos - lo
    if frac == 0.0 or lo + 1 >= len(vs):
        return vs[lo]
    return vs[lo] * (1.0 - frac) + vs[lo + 1] * frac


class MetricsCollector:
    def __init__(self):
        self.ttfts: List[float] = []
        self.tbts: List[float] = []
        self.fetch_latencies: List[float] = []
        self.finished = 0

    def record(self, req) -> None:
        self.finished += 1
        if req.ttft is not None:
            self.ttfts.append(req.ttft)
        tbt = req.tbt
        if tbt is not None and tbt > 0:
            self.tbts.append(tbt)
        self.fetch_latencies.append(getattr(req, "fetch_latency", 0.0))

    def summary(self) -> dict:
        return {
            "finished": self.finished,
            "p50_ttft": percentile(self.ttfts, 50),
            "p95_ttft": percentile(self.ttfts, 95),
            "p99_ttft": percentile(self.ttfts, 99),
            "mean_tbt": (sum(self.tbts) / len(self.tbts)
                         if self.tbts else float("nan")),
            "p95_tbt": percentile(self.tbts, 95),
            "mean_fetch_latency": (sum(self.fetch_latencies) /
                                   len(self.fetch_latencies)
                                   if self.fetch_latencies else 0.0),
            "p95_fetch_latency": percentile(self.fetch_latencies, 95)
            if self.fetch_latencies else 0.0,
        }
