"""SLO specification + windowed attainment tracking (paper §V, Fig 10).

An ``SLOSpec`` names the latency targets a deployment promises (TTFT
and optionally TBT) and the attainment fraction that counts as healthy
(e.g. 95% of requests under 10 s TTFT). ``SLOTracker`` scores every
finished request against the spec over a sliding window; the controller
reads ``attainment`` / ``violated`` / ``headroom`` to decide when to
rebalance, scale up, or drain.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Deque, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    ttft: float = 10.0                  # seconds to first token
    tbt: Optional[float] = None         # seconds/token; None = untracked
    target: float = 0.95                # required attainment fraction
    window: float = 30.0                # seconds of history scored

    def met_by(self, ttft: Optional[float],
               tbt: Optional[float]) -> bool:
        if ttft is None or ttft > self.ttft:
            return False
        if self.tbt is not None and tbt is not None and tbt > self.tbt:
            return False
        return True


class SLOTracker:
    def __init__(self, spec: SLOSpec):
        self.spec = spec
        self._scores: Deque[Tuple[float, bool]] = collections.deque()
        self.scored = 0
        self.met = 0

    # -- feeds ------------------------------------------------------------
    def observe(self, req, now: float) -> bool:
        ok = self.spec.met_by(req.ttft, req.tbt)
        self._push(now, ok)
        return ok

    def observe_timeout(self, now: float) -> None:
        """A dropped request is an SLO miss, not a gap in the data."""
        self._push(now, False)

    def _push(self, now: float, ok: bool) -> None:
        self._scores.append((now, ok))
        self.scored += 1
        self.met += ok

    # -- windowed state ---------------------------------------------------
    def _prune(self, now: float) -> None:
        cutoff = now - self.spec.window
        while self._scores and self._scores[0][0] < cutoff:
            self._scores.popleft()

    def sample_count(self, now: float) -> int:
        self._prune(now)
        return len(self._scores)

    def attainment(self, now: float) -> float:
        """Fraction of windowed requests meeting the spec; 1.0 when the
        window is empty (no evidence of trouble)."""
        self._prune(now)
        if not self._scores:
            return 1.0
        return sum(ok for _, ok in self._scores) / len(self._scores)

    def violated(self, now: float, min_samples: int = 5) -> bool:
        return (self.sample_count(now) >= min_samples
                and self.attainment(now) < self.spec.target)

    def headroom(self, now: float, min_samples: int = 5) -> bool:
        """Attainment at-or-above target on real evidence — the
        controller combines this with a windowed-P95 latency margin
        (from telemetry) before it dares drain a server."""
        return (self.sample_count(now) >= min_samples
                and self.attainment(now) >= self.spec.target)

    def lifetime_attainment(self) -> float:
        return self.met / self.scored if self.scored else 1.0
