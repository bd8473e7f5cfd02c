"""Exactly-once request re-dispatch (the chaos plane's recovery side).

When a server dies mid-decode, its in-flight requests are re-issued on
a survivor *from the last client-visible token*: a **continuation**
request carries the same ``req_id``, the already-generated tokens
folded into its prompt (real engine: re-prefill of prompt + generated
context, so greedy decode continues the identical sequence; sim:
``prompt_len`` grows by the delivered count), and an output budget of
only the remaining tokens. The host keeps streaming positions keyed by
``req_id``, so the client-visible stream is the concatenation —
no token is ever lost or duplicated.

``merge_continuation`` folds the finished continuation back into the
original request object, because hosts track completion by object
identity (``LoRAServeCluster._report``'s ``id(r)`` set).
"""
from __future__ import annotations

import dataclasses
from typing import List

from repro_torch.core.request import Phase, ServeRequest


def delivered_tokens(req: ServeRequest) -> int:
    """Tokens of ``req`` that exist host-side (>= the client-visible
    watermark): concrete outputs on the real engine, the decode counter
    in the sim."""
    if req.prompt is not None:
        return len(req.output)
    return req.decoded


def remaining_tokens(req: ServeRequest) -> int:
    return max(0, req.output_len - delivered_tokens(req))


def make_continuation(req: ServeRequest, now: float) -> ServeRequest:
    """Build the re-dispatch request for ``req``'s undelivered suffix.
    Same ``req_id`` (streams are keyed by it); fresh lifecycle."""
    done = delivered_tokens(req)
    if req.prompt is not None:
        prompt: List[int] = list(req.prompt) + list(req.output)
        return ServeRequest(req_id=req.req_id,
                            adapter_id=req.adapter_id, rank=req.rank,
                            prompt_len=len(prompt),
                            output_len=remaining_tokens(req),
                            arrival=now, prompt=prompt)
    return ServeRequest(req_id=req.req_id, adapter_id=req.adapter_id,
                        rank=req.rank, prompt_len=req.prompt_len + done,
                        output_len=remaining_tokens(req), arrival=now)


def merge_continuation(orig: ServeRequest, cont: ServeRequest) -> None:
    """Fold a finished continuation back into the original request so
    the host's identity-keyed bookkeeping sees one completed request
    with the full output and end-to-end timestamps."""
    assert cont.req_id == orig.req_id, "continuation req_id mismatch"
    base = delivered_tokens(orig)
    if orig.prompt is not None:
        orig.output = list(orig.output) + list(cont.output)
    orig.decoded = base + cont.decoded
    orig.server = cont.server
    orig.finish = cont.finish
    orig.t_finish = cont.t_finish
    orig.phase = cont.phase
    orig.prefill_done = (orig.prefill_done if orig.prefill_done >= 0
                         else cont.prefill_done)
    if orig.t_first_token is None:
        orig.t_first_token = cont.t_first_token


@dataclasses.dataclass
class RecoveryRecord:
    """Audit record of one crash recovery (chaos harness + flight
    recorder payload)."""
    server: int
    detected_at: float
    recovered_at: float
    redispatched: int
    orphaned_adapters: int

    @property
    def recovery_time(self) -> float:
        return self.recovered_at - self.detected_at
