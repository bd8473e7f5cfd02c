"""Flight recorder: bounded ring of recent spans, dumped on anomalies.

Subscribed as a tracer listener, it keeps the last ``capacity`` spans
in a ring buffer. When the control plane hits an anomaly — SLO
violation flips on, the controller decides to scale up or drain, a
request times out — ``dump()`` snapshots the ring as a Perfetto trace
plus an *audit record* of the controller's decision inputs (drift
events, attainment window, demand estimate), so a post-mortem can see
exactly what the last seconds of traffic looked like and what numbers
the controller acted on.

Dumps are rate-limited (``min_interval`` on the recording clock) and
capped (``max_dumps``) so a sustained violation can't fill the disk.
With no ``out_dir`` the dumps stay in memory (``dumps`` list) — the
mode the tests and the sim substrate use.
"""
from __future__ import annotations

import json
import os
from collections import deque
from typing import List, Optional

from .export import span_to_dict, to_perfetto
from .trace import Span


class FlightRecorder:
    def __init__(self, capacity: int = 2048, *,
                 out_dir: Optional[str] = None,
                 min_interval: float = 1.0,
                 max_dumps: int = 50):
        self.ring: deque = deque(maxlen=capacity)
        self.out_dir = out_dir
        self.min_interval = min_interval
        self.max_dumps = max_dumps
        self.dumps: List[dict] = []      # in-memory dump records
        self.suppressed = 0              # rate-limited / capped dump calls
        self._last_dump: Optional[float] = None
        self._seq = 0

    # tracer listener
    def observe(self, span: Span) -> None:
        self.ring.append(span)

    @property
    def n_dumps(self) -> int:
        return len(self.dumps)

    def dump(self, reason: str, now: float,
             audit: Optional[dict] = None) -> Optional[dict]:
        """Snapshot the ring. Returns the dump record, or None when
        rate-limited/capped."""
        if len(self.dumps) >= self.max_dumps:
            self.suppressed += 1
            return None
        if self._last_dump is not None \
                and now - self._last_dump < self.min_interval:
            self.suppressed += 1
            return None
        self._last_dump = now
        self._seq += 1
        spans = list(self.ring)
        record = {
            "seq": self._seq,
            "reason": reason,
            "time": now,
            "n_spans": len(spans),
            "audit": audit or {},
            "spans": [span_to_dict(s) for s in spans],
        }
        self.dumps.append(record)
        if self.out_dir:
            os.makedirs(self.out_dir, exist_ok=True)
            stem = os.path.join(
                self.out_dir, f"flight-{self._seq:04d}-{reason}")
            with open(stem + ".perfetto.json", "w") as f:
                json.dump(to_perfetto(spans), f)
            with open(stem + ".audit.json", "w") as f:
                json.dump({k: v for k, v in record.items()
                           if k != "spans"}, f, indent=2, default=str)
        return record
