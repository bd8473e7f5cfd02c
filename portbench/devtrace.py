"""The device trace of a traced run: ``torch.profiler`` over a slice of the
window, read from its raw events (device operations with their times, the
host's operations around them).

``Trace`` holds what the per-layer readers and the result's ``breakdown``
read: every device operation (name, start, end in µs), the union of their
intervals (``busy_s``), the traced wall time (``window_s``), and the idle
gaps between device operations, each put down to what the host was doing
at its midpoint (the innermost host operation running then, or "python"
where none was).
"""
from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict
from typing import List, Tuple

import torch
from torch.profiler import ProfilerActivity, profile

TOP = 10


def start():
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    return prof


def _ns(ev, what: str) -> float:
    fn = getattr(ev, f"{what}_ns", None)
    if fn is not None:
        return fn() / 1e3
    return float(getattr(ev, f"{what}_us")())


@dataclasses.dataclass
class Trace:
    device_ops: List[Tuple[str, float, float]]      # (name, start, end) µs
    host_ops: List[Tuple[float, float, str]]        # sorted by start
    window_s: float

    @property
    def busy_s(self) -> float:
        busy, end = 0.0, float("-inf")
        for _, s, e in sorted(self.device_ops, key=lambda o: o[1]):
            if e > end:
                busy += e - max(s, end)
                end = e
        return busy / 1e6

    def device_time_s(self, patterns) -> float:
        """Summed device time of the operations whose name holds one of
        ``patterns``."""
        return sum(e - s for n, s, e in self.device_ops
                   if any(p in n for p in patterns)) / 1e6

    def breakdown(self) -> dict:
        by_op = defaultdict(float)
        for n, s, e in self.device_ops:
            by_op[n] += (e - s) / 1e6
        gaps = defaultdict(float)
        end = None
        starts = [h[0] for h in self.host_ops]
        for n, s, e in sorted(self.device_ops, key=lambda o: o[1]):
            if end is not None and s > end:
                gaps[self._host_at_sorted(starts, (s + end) / 2)] += \
                    (s - end) / 1e6
            end = e if end is None else max(end, e)
        top = sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP]
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[n[:64], v] for n, v in top],
                "idle_gaps": [[n[:64], v] for n, v in idle]}

    def _host_at_sorted(self, starts, t: float) -> str:
        """The innermost host operation running at ``t``: the latest
        started of those still running (host operations nest)."""
        i = bisect.bisect_right(starts, t) - 1
        for j in range(i, max(-1, i - 64), -1):
            if self.host_ops[j][1] >= t:
                return self.host_ops[j][2]
        return "python"


def finish(prof, window_s: float) -> Trace:
    """Stop ``prof`` and read its events."""
    prof.stop()
    dev, host = [], []
    cuda = torch.autograd.DeviceType.CUDA
    for ev in prof.profiler.kineto_results.events():
        s = _ns(ev, "start")
        e = s + _ns(ev, "duration")
        if ev.device_type() == cuda:
            dev.append((ev.name(), s, e))
        elif not ev.name().startswith("cuda"):
            host.append((s, e, ev.name()))
    host.sort()
    return Trace(dev, host, window_s)
