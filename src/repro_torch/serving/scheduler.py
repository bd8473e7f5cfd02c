"""Trace-driven driver for a ServingEngine: replays (arrival, request)
streams against wall-clock time, collecting TTFT/TBT.

Replay timing is kept local: instead of rebasing ``r.arrival`` to
wall-clock in place (which corrupted requests for any second use), the
engine is temporarily driven by a *trace-relative* clock — ``now`` is
seconds since replay start, scaled by ``speedup`` — so the engine's
timestamps land in the same domain as the untouched arrivals.
"""
from __future__ import annotations

import time
import warnings
from typing import List

from .engine import ServingEngine
from .request import ServeRequest


def replay(engine: ServingEngine, requests: List[ServeRequest],
           speedup: float = 1.0, max_iters: int = 1_000_000) -> dict:
    """Feed `requests` (with .arrival in seconds) into the engine in real
    time (optionally compressed by `speedup`), stepping the engine
    continuously. Returns the metrics summary plus an ``exhausted`` key:
    True when the iteration budget ran out with requests still pending
    (a truncated replay must not masquerade as a complete one). Does not
    mutate arrivals."""
    pending = sorted(requests, key=lambda r: r.arrival)
    t0 = time.monotonic()
    old_clock = engine._clock
    engine._clock = lambda: (time.monotonic() - t0) * speedup
    i = 0
    iters = 0
    try:
        while (i < len(pending) or engine.queue or engine.active) \
                and iters < max_iters:
            now = (time.monotonic() - t0) * speedup
            while i < len(pending) and pending[i].arrival <= now:
                engine.submit(pending[i])
                i += 1
            engine.step()
            iters += 1
    finally:
        engine._clock = old_clock
    summary = engine.metrics.summary()
    left = (len(pending) - i) + len(engine.queue) + engine.active
    summary["exhausted"] = left > 0
    if summary["exhausted"]:
        warnings.warn(
            f"replay stopped at max_iters={max_iters} with {left} "
            f"request(s) still pending — metrics cover a truncated run",
            RuntimeWarning, stacklevel=2)
    return summary
