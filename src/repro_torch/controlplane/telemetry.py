"""Sliding-window cluster telemetry — the control plane's sensor layer.

``TelemetryHub`` aggregates the existing request lifecycle events
(arrival routing, completion, timeout) into windowed per-adapter and
per-server statistics: token/request rates and windowed TTFT/TBT
percentiles. (Queue depths are instantaneous backend state, not event
history — the hosts snapshot them into ``ClusterState`` per tick.) Both substrates feed it from the same places the
``DemandEstimator`` already observes, but where the estimator keeps one
smoothed level per adapter for *placement*, the hub keeps raw
timestamped samples so the drift detector and SLO tracker can look at
the actual recent distribution.
"""
from __future__ import annotations

import bisect
import collections
from typing import Deque, Dict, Iterator, List, Optional, Tuple

from repro_torch.serving.metrics import percentile


class SlidingWindow:
    """Timestamped samples pruned to a fixed horizon."""

    def __init__(self, horizon: float):
        self.horizon = horizon
        self._samples: Deque[Tuple[float, float]] = collections.deque()
        self._first: Optional[float] = None   # first-ever sample time

    def push(self, t: float, value: float) -> None:
        if self._first is None:
            self._first = t
        self._samples.append((t, value))

    def prune(self, now: float) -> None:
        cutoff = now - self.horizon
        q = self._samples
        while q and q[0][0] < cutoff:
            q.popleft()

    def values(self, now: float) -> List[float]:
        self.prune(now)
        return [v for _, v in self._samples]

    def count(self, now: float) -> int:
        self.prune(now)
        return len(self._samples)

    def total(self, now: float) -> float:
        self.prune(now)
        return sum(v for _, v in self._samples)

    def rate(self, now: float) -> float:
        """Sum of samples per second over the (elapsed part of the)
        window. Early in a feed the divisor is the time actually covered
        — measured from the first sample ever pushed, NOT from t=0: an
        engine wall clock or an offset-arrival trace can start feeding
        at an arbitrary clock value, and dividing by ``now`` would
        deflate those rates by however late the feed began."""
        if self._first is None:
            return 0.0
        span = min(self.horizon, now - self._first)
        if span <= 0.0:
            span = 1.0
        return self.total(now) / span


# log-spaced latency buckets, 1ms .. 60s (Prometheus `le` upper bounds)
DEFAULT_LATENCY_BOUNDS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


class Histogram:
    """Cumulative fixed-bucket histogram with Prometheus `histogram`
    semantics: ``cumulative()`` yields ``(le, count-with-value<=le)``
    pairs ending in ``("+Inf", total)``, plus ``sum``/``count`` — the
    `_bucket`/`_sum`/`_count` series external scrapers aggregate."""

    def __init__(self, bounds=DEFAULT_LATENCY_BOUNDS):
        self.bounds = tuple(bounds)
        self._counts = [0] * (len(self.bounds) + 1)  # last = +Inf
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        # Prometheus le semantics: bucket i counts value <= bounds[i]
        self._counts[bisect.bisect_left(self.bounds, value)] += 1
        self.sum += value
        self.count += 1

    def cumulative(self) -> Iterator[Tuple[object, int]]:
        cum = 0
        for le, c in zip(self.bounds, self._counts):
            cum += c
            yield le, cum
        yield "+Inf", self.count

    def to_dict(self) -> dict:
        return {"buckets": list(self.cumulative()),
                "sum": self.sum, "count": self.count}


class TelemetryHub:
    def __init__(self, window: float = 30.0):
        self.window = window
        self._adapter_tokens: Dict[str, SlidingWindow] = {}
        self._adapter_requests: Dict[str, SlidingWindow] = {}
        self._server_tokens: Dict[int, SlidingWindow] = {}
        self._ttft = SlidingWindow(window)
        self._tbt = SlidingWindow(window)
        self._server_ttft: Dict[int, SlidingWindow] = {}
        # cumulative (never-pruned) latency histograms: the Prometheus
        # `histogram`-typed complement of the windowed percentiles, so
        # external scrapers can rate() and aggregate across gateways
        self.ttft_hist = Histogram()
        self.tbt_hist = Histogram()
        self.arrivals = 0
        self.completions = 0
        self.timeouts = 0

    def _win(self, table: Dict, key) -> SlidingWindow:
        w = table.get(key)
        if w is None:
            w = table[key] = SlidingWindow(self.window)
        return w

    # -- feeds ------------------------------------------------------------
    def observe_arrival(self, adapter_id: str, server: int,
                        tokens: float, now: float) -> None:
        self.arrivals += 1
        self._win(self._adapter_tokens, adapter_id).push(now, tokens)
        self._win(self._adapter_requests, adapter_id).push(now, 1.0)
        self._win(self._server_tokens, server).push(now, tokens)

    def observe_completion(self, req, now: float) -> None:
        """Feed one finished ``ServeRequest`` (either substrate)."""
        self.completions += 1
        ttft, tbt = req.ttft, req.tbt
        if ttft is not None and ttft >= 0:
            self._ttft.push(now, ttft)
            self._win(self._server_ttft, req.server).push(now, ttft)
            self.ttft_hist.observe(ttft)
        if tbt is not None and tbt > 0:
            self._tbt.push(now, tbt)
            self.tbt_hist.observe(tbt)

    def observe_timeout(self, now: float) -> None:
        self.timeouts += 1

    # -- windowed accessors ----------------------------------------------
    # (queue depths flow through ClusterState, host-built per tick —
    # they are instantaneous backend state, not event-stream history)
    def adapter_token_rate(self, adapter_id: str, now: float) -> float:
        w = self._adapter_tokens.get(adapter_id)
        return w.rate(now) if w else 0.0

    def adapter_request_rate(self, adapter_id: str, now: float) -> float:
        w = self._adapter_requests.get(adapter_id)
        return w.rate(now) if w else 0.0

    def adapter_rates(self, now: float) -> Dict[str, float]:
        """Per-adapter windowed token rates — the drift detector's
        input signal."""
        return {aid: w.rate(now)
                for aid, w in self._adapter_tokens.items()}

    def server_token_rate(self, server: int, now: float) -> float:
        w = self._server_tokens.get(server)
        return w.rate(now) if w else 0.0

    def ttft_percentile(self, p: float, now: float) -> Optional[float]:
        vs = self._ttft.values(now)
        return percentile(vs, p) if vs else None

    def tbt_percentile(self, p: float, now: float) -> Optional[float]:
        vs = self._tbt.values(now)
        return percentile(vs, p) if vs else None

    def server_ttft_percentile(self, server: int, p: float,
                               now: float) -> Optional[float]:
        w = self._server_ttft.get(server)
        vs = w.values(now) if w else []
        return percentile(vs, p) if vs else None

    def sample_count(self, now: float) -> int:
        return self._ttft.count(now)

    def snapshot(self, now: float) -> dict:
        """One consistent windowed view at ``now`` — what a live
        ``/metrics`` scrape renders. Percentile entries are ``None``
        (not NaN, not inf) while the window is empty so renderers can
        skip them cleanly."""
        return {
            "now": now,
            "window": self.window,
            "arrivals": self.arrivals,
            "completions": self.completions,
            "timeouts": self.timeouts,
            "samples": self.sample_count(now),
            "ttft_p50": self.ttft_percentile(50, now),
            "ttft_p95": self.ttft_percentile(95, now),
            "tbt_p50": self.tbt_percentile(50, now),
            "tbt_p95": self.tbt_percentile(95, now),
            "ttft_hist": self.ttft_hist.to_dict(),
            "tbt_hist": self.tbt_hist.to_dict(),
            "adapter_token_rates": self.adapter_rates(now),
            "adapter_request_rates": {
                aid: w.rate(now)
                for aid, w in self._adapter_requests.items()},
            "server_token_rates": {
                sid: w.rate(now)
                for sid, w in self._server_tokens.items()},
        }
