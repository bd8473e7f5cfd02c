"""Host spans inside the port's serving loop (category ``host``) and the
snapshots that put them on the device trace's clock (category ``clock``).

The engine splits each iteration span into the part that enqueues its
work and the part that waits for the card: a ``decode`` span is
``decode.launch`` then ``decode.sync``, a ``prefill`` span
``prefill.launch``, ``prefill.sync`` and ``prefill.merge``, the children
telescoping exactly to the parent. ``finish`` covers the token
bookkeeping after a decode span and ``admit`` a whole admission pass.
While a launch is open the engine puts a ``HostParts`` into ``PARTS``,
the one slot through which the model's functions, which take no tracer,
count the host self time of their parts: ``attention`` (less the LoRA
calls inside it), ``lora`` (the hook ``make_lora_cb`` returns, and its
binding per layer), ``ffn`` and ``logits`` (the head and the argmax). The
launch span carries them as ``attrs["host_s"]`` and ``attrs["calls"]``,
and ``attrs["lora_layouts"]``, the SGMV segment layouts that the engine's
``LayoutPlan``s built inside it (0 where the batch's layout was built
before).
Without a tracer ``PARTS`` stays ``None`` and an instrumented call costs
one read of it.

``PollSpans`` gives the cluster facade over a wall-clock backend a
``poll`` span (track ``control``) for every poll that stepped an engine
with work, and at most one ``clock`` snapshot a second: an instant span
at a cluster-clock reading whose ``attrs["unix_ns"]`` is
``time.time_ns()`` read beside it, the epoch of ``torch.profiler``'s
event times: a reader maps a profiler time onto the cluster clock by the
nearest snapshot.
"""
from __future__ import annotations

import functools
import time
from typing import Callable, Dict, Optional

# the counters of the launch the engine has open; None without a tracer
PARTS: Optional["HostParts"] = None

SNAPSHOT_EVERY_S = 1.0


class HostParts:
    """Host self time (on ``clock``, seconds) and calls of each model part
    inside one launch. A part timed inside another is taken out of the
    outer one's self time, so the parts never sum past the launch."""

    __slots__ = ("clock", "self_s", "calls", "_inner")

    def __init__(self, clock: Callable[[], float]):
        self.clock = clock
        self.self_s: Dict[str, float] = {}
        self.calls: Dict[str, int] = {}
        self._inner = 0.0            # time of the parts nested in this one

    def run(self, part: str, fn, *args, **kw):
        outer, self._inner = self._inner, 0.0
        t0 = self.clock()
        try:
            return fn(*args, **kw)
        finally:
            dt = self.clock() - t0
            self.self_s[part] = self.self_s.get(part, 0.0) + dt - self._inner
            self.calls[part] = self.calls.get(part, 0) + 1
            self._inner = outer + dt

    def timed(self, part: str, fn):
        """``fn`` counted as ``part`` whenever it is called."""
        return functools.partial(self.run, part, fn)

    def attrs(self) -> dict:
        return {"host_s": self.self_s, "calls": self.calls}


def open_parts(clock: Callable[[], float]) -> HostParts:
    """Start counting a launch's parts on ``clock``; ``close_parts`` ends
    it."""
    global PARTS
    PARTS = HostParts(clock)
    return PARTS


def close_parts() -> None:
    global PARTS
    PARTS = None


class PollSpans:
    """The facade's ``poll`` spans and ``clock`` snapshots on ``tracer``,
    stamped on the facade's ``clock``. A poll that stepped no engine with
    work records no span; the next span counts such polls in
    ``attrs["idle_polls"]``."""

    def __init__(self, tracer, clock: Callable[[], float]):
        self.tracer = tracer
        self.clock = clock
        self.t0 = 0.0
        self.idle_polls = 0
        self.worked = False
        self.next_snapshot = float("-inf")
        tracer.add_listener(self._observe)

    def _observe(self, span) -> None:
        if span.track.startswith("server:"):
            self.worked = True

    def snapshot(self) -> None:
        u0 = time.time_ns()
        t = self.clock()
        u1 = time.time_ns()
        self.tracer.record("clock", t, t, cat="clock", track="control",
                           attrs={"unix_ns": (u0 + u1) // 2})
        self.next_snapshot = t + SNAPSHOT_EVERY_S

    def open(self) -> None:
        t = self.clock()
        if t >= self.next_snapshot:
            self.snapshot()
            t = self.clock()
        self.worked = False
        self.t0 = t

    def close(self) -> None:
        if not self.worked:
            self.idle_polls += 1
            return
        self.tracer.record("poll", self.t0, self.clock(), cat="host",
                           track="control",
                           attrs={"idle_polls": self.idle_polls})
        self.idle_polls = 0



def poll_spans(tracer, backend, clock) -> Optional[PollSpans]:
    """The facade's ``PollSpans`` over a wall-clock backend; None over a
    virtual one, whose spans stay the simulator's."""
    return PollSpans(tracer, clock) if backend.realtime else None
