"""What the readers of the program's host spans share: the engine's
``decode.launch`` and ``prefill.launch`` spans, the facade's ``poll``
spans and the ``clock`` snapshots that map the device trace's times onto
the cluster clock (the port's ``repro_torch/obs/host.py`` records them).

A program without these spans gives each reader nothing to read: it
returns None.
"""
from __future__ import annotations

import bisect
from typing import List, Optional, Sequence, Tuple

from .readers import iteration_spans

LAUNCHES = ("decode.launch", "prefill.launch")


def host_spans(ctx, name: str, t0: float, t1: float):
    """The ``host`` spans named ``name`` that lie inside [t0, t1]."""
    return [s for s in ctx.spans if s.name == name and s.cat == "host"
            and t0 <= s.start and s.end <= t1]


def _per_step_ms(ctx, value) -> Optional[float]:
    launches = host_spans(ctx, "decode.launch", ctx.t_open, ctx.t_close)
    steps = sum(s.attrs["steps"] for s in iteration_spans(ctx, "decode"))
    if not launches or not steps:
        return None
    return 1e3 * sum(value(s) for s in launches) / steps


def decode_launch_ms(ctx) -> Optional[float]:
    """Summed ``decode.launch`` time over the decode steps of the
    ``decode`` spans in the window (ms a step)."""
    return _per_step_ms(ctx, lambda s: s.end - s.start)


def lora_host_ms(ctx) -> Optional[float]:
    """Summed host self time of the LoRA part on those launches over the
    same steps (ms a step)."""
    if not any("lora" in s.attrs.get("host_s", {}) for s in host_spans(
            ctx, "decode.launch", ctx.t_open, ctx.t_close)):
        return None
    return _per_step_ms(ctx, lambda s: s.attrs["host_s"].get("lora", 0.0))


def _union(intervals) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        elif e > s:
            out.append((s, e))
    return out


def _overlap(a: Sequence[Tuple[float, float]],
             b: Sequence[Tuple[float, float]]) -> float:
    """Length of the intersection of two sorted disjoint interval lists."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def facade_share(ctx) -> Optional[float]:
    """The facade's self time in the window, ``poll`` spans less the
    engine's spans inside them, over the window (%)."""
    polls = [s for s in ctx.spans if s.name == "poll" and s.cat == "host"
             and ctx.t_open <= s.start and s.end <= ctx.t_close]
    if not polls:
        return None
    engine = _union((s.start, s.end) for s in ctx.spans
                    if s.cat in ("host", "iteration")
                    and s.track.startswith("server:")
                    and s.end >= ctx.t_open and s.start <= ctx.t_close)
    polls_u = _union((s.start, s.end) for s in polls)
    own = sum(e - s for s, e in polls_u) - _overlap(polls_u, engine)
    return 100 * own / ctx.window_s


def snapshots(spans) -> List[Tuple[int, float]]:
    """(unix ns, cluster s) of every ``clock`` snapshot, by unix time."""
    return sorted((s.attrs["unix_ns"], s.start) for s in spans
                  if s.name == "clock" and s.cat == "clock")


def to_cluster(snaps: Sequence[Tuple[int, float]], unix_us: float) -> float:
    """The cluster time of a Unix-epoch time in µs (``torch.profiler``'s
    event times) by the nearest snapshot of ``snaps``."""
    ns = unix_us * 1e3
    i = bisect.bisect_left(snaps, (ns,))
    near = min(snaps[max(0, i - 1):i + 1], key=lambda s: abs(s[0] - ns))
    return near[1] + (ns - near[0]) / 1e9


def device_ops_on_cluster(ctx) -> Optional[List[Tuple[str, float, float]]]:
    """The trace's device operations (name, start, end) in cluster
    seconds; None without a trace or snapshots."""
    snaps = snapshots(ctx.spans)
    if ctx.trace is None or not snaps:
        return None
    return [(n, to_cluster(snaps, s), to_cluster(snaps, e))
            for n, s, e in ctx.trace.device_ops]


def launch_idle_share(ctx) -> Optional[float]:
    """The traced slice's time with no device operation that lies inside
    a ``decode.launch`` or ``prefill.launch`` span, over the slice (%):
    the idle time a launch leaves, of ``device_idle_share``'s."""
    if ctx.kind == "cpu":
        return None
    ops = device_ops_on_cluster(ctx)
    t0, t1 = ctx.trace_span
    launches = _union((max(s.start, t0), min(s.end, t1))
                      for s in ctx.spans if s.cat == "host"
                      and s.name in LAUNCHES and s.end > t0 and s.start < t1)
    if ops is None or not launches:
        return None
    busy = _union((s, e) for _, s, e in ops)
    idle = sum(e - s for s, e in launches) - _overlap(launches, busy)
    return 100 * idle / ctx.trace.window_s
