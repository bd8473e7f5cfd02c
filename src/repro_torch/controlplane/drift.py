"""Online per-adapter demand drift detection (paper Fig 10 shapes).

Each adapter's windowed token rate is sampled once per controller tick
and fed to a Page–Hinkley changepoint test over *relative* deviations
(sample / long-run EWMA baseline - 1), so one lambda works across
adapters whose absolute rates differ by orders of magnitude. A fast
EWMA tracks the post-change level; the ratio of fast to baseline at
detection time classifies the event:

* ``surge``  — abrupt jump (fast/baseline >= ``surge_ratio``), the
  Fig 10 late-surge adapter;
* ``rising`` / ``falling`` — gradual trend crossings;
* ``diurnal`` — an adapter that keeps alternating rising/falling
  detections (the sinusoidal Fig 10 pattern) is re-labeled once the
  oscillation shows up.

Detections reset the test, so a persistent new level re-arms instead of
firing forever.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

KIND_RISING = "rising"
KIND_FALLING = "falling"
KIND_SURGE = "surge"
KIND_DIURNAL = "diurnal"


@dataclasses.dataclass(frozen=True)
class DriftEvent:
    adapter_id: str
    kind: str            # rising | falling | surge | diurnal
    time: float
    baseline: float      # long-run EWMA rate at detection
    level: float         # fast EWMA rate at detection
    magnitude: float     # level / baseline (0 when baseline is 0)


class _AdapterState:
    __slots__ = ("baseline", "fast", "mt_up", "min_up", "mt_dn", "max_dn",
                 "samples", "directions")

    def __init__(self):
        self.baseline: Optional[float] = None   # slow EWMA
        self.fast: Optional[float] = None       # fast EWMA
        self.mt_up = self.min_up = 0.0          # PH cumulative, upward
        self.mt_dn = self.max_dn = 0.0          # PH cumulative, downward
        self.samples = 0
        self.directions: List[str] = []         # detection history


class DriftDetector:
    def __init__(self, *, slow_alpha: float = 0.03, fast_alpha: float = 0.5,
                 delta: float = 0.25, lam: float = 2.5,
                 surge_ratio: float = 1.8, warmup_samples: int = 4,
                 min_rate: float = 0.0, diurnal_flips: int = 3):
        self.slow_alpha = slow_alpha
        self.fast_alpha = fast_alpha
        self.delta = delta          # PH drift tolerance (relative units)
        self.lam = lam              # PH detection threshold
        self.surge_ratio = surge_ratio
        self.warmup_samples = warmup_samples
        self.min_rate = min_rate    # ignore adapters quieter than this
        self.diurnal_flips = diurnal_flips
        self._state: Dict[str, _AdapterState] = {}
        self.events: List[DriftEvent] = []

    # -- single-adapter update -------------------------------------------
    def update(self, adapter_id: str, rate: float,
               now: float) -> Optional[DriftEvent]:
        st = self._state.setdefault(adapter_id, _AdapterState())
        st.samples += 1
        if st.baseline is None:
            st.baseline = st.fast = rate
            return None
        if rate < self.min_rate and st.baseline < self.min_rate:
            return None    # tail adapter: too quiet to call drift on
        st.fast = (self.fast_alpha * rate
                   + (1 - self.fast_alpha) * st.fast)
        # relative deviation against the *pre-update* baseline
        x = rate / st.baseline - 1.0 if st.baseline > 1e-9 else \
            (1.0 if rate > 1e-9 else 0.0)
        st.baseline = (self.slow_alpha * rate
                       + (1 - self.slow_alpha) * st.baseline)
        st.mt_up += x - self.delta
        st.min_up = min(st.min_up, st.mt_up)
        st.mt_dn += x + self.delta
        st.max_dn = max(st.max_dn, st.mt_dn)
        if st.samples <= self.warmup_samples:
            return None
        ev: Optional[DriftEvent] = None
        if st.mt_up - st.min_up > self.lam:
            ev = self._emit(adapter_id, st, now, up=True)
        elif st.max_dn - st.mt_dn > self.lam:
            ev = self._emit(adapter_id, st, now, up=False)
        return ev

    def _emit(self, adapter_id: str, st: _AdapterState, now: float,
              up: bool) -> DriftEvent:
        baseline = st.baseline or 0.0
        level = st.fast or 0.0
        mag = level / baseline if baseline > 1e-9 else 0.0
        if up:
            kind = KIND_SURGE if mag >= self.surge_ratio else KIND_RISING
        else:
            kind = KIND_FALLING
        st.directions.append("up" if up else "down")
        if self._oscillating(st.directions):
            kind = KIND_DIURNAL
        # reset the test; keep the EWMAs so a new level re-arms cleanly
        st.mt_up = st.min_up = 0.0
        st.mt_dn = st.max_dn = 0.0
        ev = DriftEvent(adapter_id=adapter_id, kind=kind, time=now,
                        baseline=baseline, level=level, magnitude=mag)
        self.events.append(ev)
        return ev

    def _oscillating(self, directions: List[str]) -> bool:
        if len(directions) < self.diurnal_flips:
            return False
        tail = directions[-self.diurnal_flips:]
        return all(a != b for a, b in zip(tail, tail[1:]))

    # -- batch update (one controller tick) -------------------------------
    def observe(self, rates: Dict[str, float],
                now: float) -> List[DriftEvent]:
        out = []
        for aid in sorted(rates):
            ev = self.update(aid, rates[aid], now)
            if ev is not None:
                out.append(ev)
        return out

    def events_for(self, adapter_id: str) -> List[DriftEvent]:
        return [e for e in self.events if e.adapter_id == adapter_id]
