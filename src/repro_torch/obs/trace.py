"""A copy of the JAX package's ``obs/trace.py``.

Flight-recorder tracing core: spans, clocks, and the ``Tracer``.

Every lifecycle point the serving stack already observes (gateway
receive, admission, routing, adapter fetch, prefill groups, decode
iterations, stream finish) can be recorded as a ``Span`` — a named
interval on the *cluster clock*. Both substrates feed the same span
names from the same places:

* the discrete-event simulator stamps spans on its event clock
  (``EventClock`` — virtual seconds, advanced by the host);
* the real engine (the port's torch ``ServingEngine``) stamps spans on wall-clock seconds since run
  start (``WallClock`` — the same domain ``EngineBackend.wall_now``
  serves).

Because both are "seconds since run start" behind the one ``Clock``
protocol, a sim trace and an engine trace of the same workload export
to the same Perfetto timeline shape and can be diffed span-for-span.

Recording is explicit-timestamp: callers pass ``(start, end)`` they
measured on their own clock, and the tracer reads no clock itself. The
port's engine and facade read their clock for a span only while a tracer
is attached (``obs/host.py``'s host spans and part counters too): without
one they read it as often as they would with no spans at all
(``tests/test_torch_engine.py`` counts the reads). With one attached, the
serving benchmark on an NVIDIA H100 80GB HBM3 (700 W) showed no cost
beyond its run-to-run spread: DeepSeek-V2-Lite's decode step read
524.3-525.9 ms traced against 524.6-529.0 ms with iteration spans only,
Qwen2.5-32B's host-paced step 265.0-267.9 against 218.5-281.7 ms.
Listeners (the flight recorder's ring buffer, the cost-model drift
meter) see every span as it is recorded.

``record_request_spans`` is the one place the per-request phase
decomposition is defined: fetch → queue → prefill → decode, clamped and
telescoping so the four child durations sum *exactly* to the root
request span (= measured TTFT + generation time) on both substrates.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Protocol, runtime_checkable


@runtime_checkable
class Clock(Protocol):
    """Seconds since run start, on whatever substrate drives it."""

    def now(self) -> float: ...


class WallClock:
    """Wall-clock seconds since construction (the engine substrate's
    time domain — matches ``EngineBackend.wall_now``)."""

    def __init__(self):
        self._t0 = time.monotonic()

    def reset(self) -> None:
        self._t0 = time.monotonic()

    def now(self) -> float:
        return time.monotonic() - self._t0


class EventClock:
    """Manually-advanced virtual clock (the simulator's event-time
    domain). The host advances it; it never goes backwards."""

    def __init__(self, t: float = 0.0):
        self.t = t

    def advance(self, t: float) -> None:
        if t > self.t:
            self.t = t

    def now(self) -> float:
        return self.t


class Span:
    """One named interval on the cluster clock.

    ``cat`` groups spans by kind: ``request`` (per-request phase
    decomposition), ``iteration`` (per-server prefill/decode batches),
    ``transfer`` (adapter-store data plane), ``gateway`` (HTTP front
    end + routing). ``track`` names the Perfetto row ("requests",
    "server:3", "store", "gateway", "control")."""

    __slots__ = ("name", "cat", "start", "end", "track", "req_id",
                 "span_id", "parent_id", "attrs")

    def __init__(self, name: str, start: float, end: float, *,
                 cat: str = "span", track: str = "",
                 req_id: Optional[int] = None, span_id: int = 0,
                 parent_id: Optional[int] = None,
                 attrs: Optional[dict] = None):
        self.name = name
        self.cat = cat
        self.start = start
        self.end = end
        self.track = track
        self.req_id = req_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.attrs = attrs if attrs is not None else {}

    @property
    def duration(self) -> float:
        return self.end - self.start

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"Span({self.name!r}, {self.start:.6f}->{self.end:.6f}, "
                f"cat={self.cat!r}, track={self.track!r}, "
                f"req={self.req_id})")


class Tracer:
    """Span sink shared by every component of one serving run.

    Keeps the full span list in memory by default (bounded by
    ``max_spans`` — oldest dropped first) and fans every span out to
    listeners (flight-recorder ring, drift meter, streaming writers).
    ``record`` is the only write path; it is deliberately allocation-
    light because the simulator calls it once per iteration."""

    def __init__(self, clock: Optional[Clock] = None, *,
                 keep_all: bool = True,
                 max_spans: Optional[int] = None):
        self.clock: Clock = clock if clock is not None else WallClock()
        self.keep_all = keep_all
        self.max_spans = max_spans
        self.spans: List[Span] = []
        self.n_spans = 0                 # total ever recorded
        self.dropped = 0                 # trimmed by max_spans
        self._listeners: List[Callable[[Span], None]] = []
        self._next_id = 1

    def now(self) -> float:
        return self.clock.now()

    def add_listener(self, fn: Callable[[Span], None]) -> None:
        if fn not in self._listeners:
            self._listeners.append(fn)

    def record(self, name: str, start: float, end: float, *,
               cat: str = "span", track: str = "",
               req_id: Optional[int] = None,
               parent: Optional[int] = None,
               attrs: Optional[dict] = None) -> Span:
        # hot path (once per sim iteration, a few times per engine
        # iteration): build the Span via __new__ + direct slot stores
        # instead of Span(...) — skipping the __init__ call and kwarg
        # re-binding is a ~25% saving on the whole record cost; the
        # port's cost with tracing on is in the module docstring
        span = Span.__new__(Span)
        span.name = name
        span.cat = cat
        span.start = start
        span.end = end
        span.track = track
        span.req_id = req_id
        sid = self._next_id
        self._next_id = sid + 1
        span.span_id = sid
        span.parent_id = parent
        span.attrs = attrs if attrs is not None else {}
        self.n_spans += 1
        if self.keep_all:
            self.spans.append(span)
            if self.max_spans is not None \
                    and len(self.spans) > self.max_spans:
                cut = len(self.spans) - self.max_spans
                del self.spans[:cut]
                self.dropped += cut
        for fn in self._listeners:
            fn(span)
        return span

    # -- queries (tests / examples) --------------------------------------
    def by_request(self) -> Dict[int, List[Span]]:
        out: Dict[int, List[Span]] = {}
        for s in self.spans:
            if s.req_id is not None:
                out.setdefault(s.req_id, []).append(s)
        return out

    def named(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name]


# -- the per-request phase decomposition ---------------------------------
REQUEST_PHASES = ("fetch", "queue", "prefill", "decode")


def record_request_spans(tracer: Tracer, req) -> Optional[Span]:
    """Emit the canonical span tree for one finished ``ServeRequest``:
    a root ``request`` span (arrival → finish) with four children —
    ``fetch`` (adapter data path), ``queue`` (admission wait),
    ``prefill``, ``decode`` — whose boundaries are clamped into the
    root so child durations telescope to *exactly* the root duration
    (= measured TTFT + generation time) on both substrates.

    Both the cluster facade and the standalone simulator call this
    one helper, which is what guarantees sim-vs-engine span-name
    parity. Returns None (and records nothing) for unfinished
    requests."""
    finish = req.finish
    if finish is None or finish < 0:
        return None
    t0 = req.arrival
    # monotone clamp: arrival <= ready <= prefill_start <= prefill_done
    # <= finish, whatever the raw stamps say (an engine admits before
    # `ready` under remote-read; a zero-output request never decodes)
    ready = min(max(req.ready, t0), finish)
    p_start = req.prefill_start if req.prefill_start >= 0 else ready
    p_start = min(max(p_start, ready), finish)
    p_done = req.prefill_done if req.prefill_done >= 0 else p_start
    p_done = min(max(p_done, p_start), finish)
    root = tracer.record(
        "request", t0, finish, cat="request", track="requests",
        req_id=req.req_id,
        attrs={"adapter_id": req.adapter_id, "rank": req.rank,
               "server": req.server, "prompt_len": req.prompt_len,
               "output_len": req.output_len})
    pid = root.span_id
    if req.remote_penalty > 0:
        fetch_mode = "remote-read"
    elif req.fetch_latency > 0:
        fetch_mode = "migrate"
    else:
        fetch_mode = "hit"
    tracer.record("fetch", t0, ready, cat="request", track="requests",
                  req_id=req.req_id, parent=pid,
                  attrs={"mode": fetch_mode,
                         "latency": req.fetch_latency})
    tracer.record("queue", ready, p_start, cat="request",
                  track="requests", req_id=req.req_id, parent=pid)
    tracer.record("prefill", p_start, p_done, cat="request",
                  track="requests", req_id=req.req_id, parent=pid,
                  attrs={"tokens": req.prompt_len})
    tracer.record("decode", p_done, finish, cat="request",
                  track="requests", req_id=req.req_id, parent=pid,
                  attrs={"tokens": max(0, req.decoded - 1)})
    return root
