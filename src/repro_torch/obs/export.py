"""Trace export: Perfetto/Chrome-trace JSON and a compact JSONL log.

The Chrome trace event format (loadable in Perfetto / chrome://tracing)
wants complete events (``ph: "X"``) with microsecond ``ts``/``dur`` and
a ``pid``/``tid`` pair naming the row. We map tracer tracks to stable
pids so a sim trace and an engine trace of the same workload land on
the same visual layout:

* ``requests``  -> pid 1, one tid per request id
* ``gateway`` / ``control`` -> pid 2
* ``store``     -> pid 3
* ``server:N``  -> pid 10 + N

The JSONL exporter writes one self-contained dict per span — grep- and
pandas-friendly, and the format the flight recorder's audit records sit
next to.
"""
from __future__ import annotations

import json
from typing import Iterable, List

from .trace import Span, Tracer

_PID_REQUESTS = 1
_PID_CONTROL = 2
_PID_STORE = 3
_PID_SERVER_BASE = 10

_PROCESS_NAMES = {
    _PID_REQUESTS: "requests",
    _PID_CONTROL: "gateway/control",
    _PID_STORE: "adapter-store",
}


def _track_pid_tid(span: Span) -> tuple:
    track = span.track
    if track.startswith("server:"):
        try:
            n = int(track.split(":", 1)[1])
        except ValueError:
            n = 0
        return _PID_SERVER_BASE + n, 0
    if track == "store":
        return _PID_STORE, 0
    if track in ("gateway", "control"):
        return _PID_CONTROL, 0
    # requests (and anything unrecognised): one row per request
    tid = span.req_id if span.req_id is not None else 0
    return _PID_REQUESTS, tid


def span_to_dict(span: Span) -> dict:
    """Self-contained JSONL record for one span (seconds, not µs)."""
    return {
        "name": span.name,
        "cat": span.cat,
        "track": span.track,
        "start": span.start,
        "end": span.end,
        "dur": span.end - span.start,
        "req_id": span.req_id,
        "span_id": span.span_id,
        "parent_id": span.parent_id,
        "attrs": span.attrs,
    }


def to_perfetto(tracer_or_spans) -> dict:
    """Chrome-trace JSON object: ``{"traceEvents": [...]}`` with one
    ``ph:"X"`` complete event per span plus ``ph:"M"`` process-name
    metadata for every pid used."""
    events: List[dict] = []
    pids = {}
    for span in _as_spans(tracer_or_spans):
        pid, tid = _track_pid_tid(span)
        if pid not in pids:
            if pid >= _PID_SERVER_BASE:
                pids[pid] = f"server:{pid - _PID_SERVER_BASE}"
            else:
                pids[pid] = _PROCESS_NAMES.get(pid, f"pid:{pid}")
        ev = {
            "name": span.name,
            "cat": span.cat,
            "ph": "X",
            "ts": span.start * 1e6,
            "dur": max(0.0, span.end - span.start) * 1e6,
            "pid": pid,
            "tid": tid,
        }
        args = dict(span.attrs) if span.attrs else {}
        args["span_id"] = span.span_id
        if span.parent_id is not None:
            args["parent_id"] = span.parent_id
        if span.req_id is not None:
            args["req_id"] = span.req_id
        ev["args"] = args
        events.append(ev)
    meta = [
        {"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
         "args": {"name": label}}
        for pid, label in sorted(pids.items())
    ]
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


def write_perfetto(tracer_or_spans, path: str) -> int:
    """Dump spans as Perfetto-loadable JSON; returns the span count."""
    spans = _as_spans(tracer_or_spans)
    doc = to_perfetto(spans)
    with open(path, "w") as f:
        json.dump(doc, f)
    return len(spans)


def write_jsonl(tracer_or_spans, path: str) -> int:
    """Dump spans as one-JSON-dict-per-line; returns the span count."""
    spans = _as_spans(tracer_or_spans)
    with open(path, "w") as f:
        for span in spans:
            f.write(json.dumps(span_to_dict(span)))
            f.write("\n")
    return len(spans)


def _as_spans(tracer_or_spans) -> List[Span]:
    if isinstance(tracer_or_spans, Tracer):
        return list(tracer_or_spans.spans)
    return list(tracer_or_spans)
