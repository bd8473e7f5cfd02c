"""A copy of the JAX package's ``obs/`` (imports renamed).

Span-based observability layer fed by both serving substrates.

``Tracer`` + ``Span`` + the ``Clock`` protocol are the core;
``export`` writes Perfetto/Chrome-trace JSON and JSONL;
``CostModelDrift`` tracks per-phase modeled-vs-measured iteration
error; ``FlightRecorder`` keeps a bounded ring of recent spans and
dumps it (with a controller-decision audit record) on SLO violations
and scale events.
"""
from .drift import CostModelDrift, predict_span_seconds
from .export import span_to_dict, to_perfetto, write_jsonl, write_perfetto
from .flight import FlightRecorder
from .trace import (Clock, EventClock, REQUEST_PHASES, Span, Tracer,
                    WallClock, record_request_spans)

__all__ = [
    "Clock", "CostModelDrift", "EventClock", "FlightRecorder",
    "REQUEST_PHASES", "Span", "Tracer", "WallClock",
    "predict_span_seconds", "record_request_spans", "span_to_dict",
    "to_perfetto", "write_jsonl", "write_perfetto",
]
