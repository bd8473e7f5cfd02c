"""Per-adapter demand (TPS) tracking and extrapolation — Algorithm 1 Step 1.

``GETPREVTIMESTEPTPS`` + ``EXTRAPOLATE``: the projected demand for the next
timestep is an EWMA-smoothed level plus a clipped linear trend, which
tracks the gradual drifts / diurnal patterns in the production traces
(paper Fig 10) without overreacting to bursts.
"""
from __future__ import annotations

import collections
from typing import Deque, Dict


class DemandEstimator:
    def __init__(self, alpha: float = 0.5, trend_beta: float = 0.5,
                 history: int = 16):
        self.alpha = alpha
        self.trend_beta = trend_beta
        self.tps_history: Dict[str, Deque[float]] = {}
        self._level: Dict[str, float] = {}
        self._trend: Dict[str, float] = {}
        self.history = history

    def observe(self, adapter_id: str, tps: float) -> None:
        """Record the measured TPS of the finished timestep (Step 1 line 4)."""
        h = self.tps_history.setdefault(
            adapter_id, collections.deque(maxlen=self.history))
        h.append(tps)
        prev_level = self._level.get(adapter_id)
        if prev_level is None:
            self._level[adapter_id] = tps
            self._trend[adapter_id] = 0.0
        else:  # Holt's linear smoothing
            level = self.alpha * tps + (1 - self.alpha) * (
                prev_level + self._trend[adapter_id])
            self._trend[adapter_id] = (
                self.trend_beta * (level - prev_level)
                + (1 - self.trend_beta) * self._trend[adapter_id])
            self._level[adapter_id] = level

    def extrapolate(self, adapter_id: str) -> float:
        """Projected TPS for the next timestep (Step 1 line 5)."""
        level = self._level.get(adapter_id, 0.0)
        trend = self._trend.get(adapter_id, 0.0)
        return max(0.0, level + trend)

    def demands(self, adapter_ids) -> Dict[str, float]:
        return {a: self.extrapolate(a) for a in adapter_ids}
