"""Request lifecycle type of the PyTorch port: a copy of the JAX
package's ``core/request.py`` (``Phase``, ``ServeRequest``, ``Request``),
kept here so the port imports nothing of ``repro``.

Every request carries its workload shape (``prompt_len``/``output_len``),
optionally concrete prompt tokens for real execution, and one set of
lifecycle timestamps on whatever clock the backend runs.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional


class Phase(enum.Enum):
    QUEUED = "queued"
    PREFILL = "prefill"
    DECODE = "decode"
    DONE = "done"


@dataclasses.dataclass
class ServeRequest:
    req_id: int
    adapter_id: str
    rank: int = 0
    prompt_len: int = 0
    output_len: int = 0
    arrival: float = 0.0
    prompt: Optional[List[int]] = None     # concrete tokens (real engine)
    # lifecycle, stamped on the backend's clock
    ready: float = 0.0                     # arrival + adapter fetch latency
    prefill_start: float = -1.0            # admitted into a prefill batch
    prefill_done: float = -1.0
    finish: float = -1.0
    server: int = -1
    decoded: int = 0
    fetch_latency: float = 0.0
    # remote-read data plane: while the local copy warms (until
    # `remote_until` on the backend clock) every iteration containing
    # this request pays `remote_penalty` seconds of GDR weight streaming
    remote_penalty: float = 0.0
    remote_until: float = -1.0
    # real-engine lifecycle
    phase: Phase = Phase.QUEUED
    output: List[int] = dataclasses.field(default_factory=list)
    slot: int = -1                         # engine batch slot
    t_first_token: Optional[float] = None
    t_finish: Optional[float] = None

    def apply_fetch_plan(self, plan, now: float) -> None:
        """Stamp readiness and remote-read fields from an adapter-store
        ``FetchPlan``: hits and remote reads start immediately (remote
        reads paying the per-iteration streaming tax until the warm copy
        lands), migrate fetches block until the ETA."""
        if plan.blocking:
            self.fetch_latency = max(0.0, plan.eta - now)
            self.ready = plan.eta
        else:
            self.ready = now
            self.fetch_latency = 0.0
            if not plan.hit:
                self.remote_penalty = plan.token_penalty
                self.remote_until = plan.eta

    @property
    def max_new_tokens(self) -> int:
        return self.output_len

    @property
    def ttft(self) -> Optional[float]:
        if self.t_first_token is not None:
            return self.t_first_token - self.arrival
        if self.prompt is not None:        # real request, prefill pending
            return None
        return self.prefill_done - self.arrival

    @property
    def tbt(self) -> Optional[float]:
        if self.prompt is not None:        # real-engine request
            if self.t_finish is None or len(self.output) <= 1 \
                    or self.t_first_token is None:
                return None
            return (self.t_finish - self.t_first_token) / \
                (len(self.output) - 1)
        if self.output_len <= 1 or self.finish < 0:
            return 0.0
        return (self.finish - self.prefill_done) / max(1, self.output_len - 1)


def Request(req_id: int, adapter_id: str, prompt: List[int],
            max_new_tokens: int, arrival: float = 0.0,
            rank: int = 0) -> ServeRequest:
    """Constructor with the engine's signature: concrete prompt tokens +
    output budget."""
    return ServeRequest(req_id=req_id, adapter_id=adapter_id, rank=rank,
                        prompt_len=len(prompt),
                        output_len=int(max_new_tokens),
                        arrival=arrival, prompt=list(prompt))
