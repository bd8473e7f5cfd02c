"""Per-tenant admission control: token-bucket rate limiting plus a
max-inflight fairness cap.

Every tenant gets its own bucket and inflight counter, so one greedy
tenant exhausts *its* budget (and starts seeing 429 + Retry-After)
while everyone else keeps admitting — the fairness property
``tests/test_torch_server.py`` pins down. Both knobs are optional: a gateway
built with neither admits everything.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


@dataclasses.dataclass
class TokenBucket:
    """Classic token bucket on the caller's clock: ``rate`` tokens/s
    refill up to ``burst`` capacity; one token per admission."""
    rate: float
    burst: float
    tokens: float = 0.0
    last: float = 0.0

    def __post_init__(self):
        self.tokens = self.burst

    def try_take(self, now: float) -> float:
        """Take one token. Returns 0.0 on success, else the seconds
        until a token will be available (the Retry-After hint)."""
        if now > self.last:
            self.tokens = min(self.burst,
                              self.tokens + (now - self.last) * self.rate)
            self.last = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return 0.0
        if self.rate <= 0:
            return float("inf")
        return (1.0 - self.tokens) / self.rate


class AdmissionController:
    """Gate one tenant's request at a time: rate bucket first, then the
    inflight cap. ``admit`` returns (ok, retry_after_seconds, reason);
    the caller must ``release`` every admitted request exactly once."""

    def __init__(self, rate: Optional[float] = None,
                 burst: Optional[float] = None,
                 max_inflight: Optional[int] = None):
        self.rate = rate
        self.burst = burst if burst is not None else \
            (max(1.0, rate) if rate is not None else 1.0)
        self.max_inflight = max_inflight
        self._buckets: Dict[str, TokenBucket] = {}
        self._inflight: Dict[str, int] = {}
        self.admitted: Dict[str, int] = {}
        self.rejected: Dict[str, int] = {}

    def inflight(self, tenant: str) -> int:
        return self._inflight.get(tenant, 0)

    def admit(self, tenant: str, now: float
              ) -> Tuple[bool, float, str]:
        if self.max_inflight is not None \
                and self.inflight(tenant) >= self.max_inflight:
            self.rejected[tenant] = self.rejected.get(tenant, 0) + 1
            # no rate involved: a slot frees when a request finishes,
            # so the hint is a short fixed backoff
            return False, 0.1, "max-inflight"
        if self.rate is not None:
            bucket = self._buckets.get(tenant)
            if bucket is None:
                bucket = self._buckets[tenant] = TokenBucket(
                    rate=self.rate, burst=self.burst, last=now)
            wait = bucket.try_take(now)
            if wait > 0:
                self.rejected[tenant] = self.rejected.get(tenant, 0) + 1
                return False, wait, "rate"
        self._inflight[tenant] = self.inflight(tenant) + 1
        self.admitted[tenant] = self.admitted.get(tenant, 0) + 1
        return True, 0.0, ""

    def release(self, tenant: str) -> None:
        n = self.inflight(tenant)
        assert n > 0, f"release without admit for tenant {tenant!r}"
        self._inflight[tenant] = n - 1
