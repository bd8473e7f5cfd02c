"""A copy of the JAX package's ``cluster/server.py``.

Iteration-level simulated LLM inference server (continuous batching à
la Orca/S-LoRA): each iteration is either a prefill batch (token-budget
bound) or a decode step for all running requests.

In the default ``bank_mode="padded"`` co-batched iterations pay the cost
of the *maximum* adapter rank present — the interference mechanism the
paper analyzes (§III-A.5). ``bank_mode="bucketed"`` mirrors the
rank-bucketed bank layout of the real engine: each iteration costs the
sum of per-bucket charges (``prefill_time_bucketed`` /
``decode_time_bucketed``), eliminating the padding tax.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from repro_torch.core.request import SimRequest  # noqa: F401  (re-export)
from repro_torch.lora.bank import rank_bucket

from .costmodel import ServerModel


def _bucket_sums(reqs, value) -> Dict[int, int]:
    """Aggregate `value(r)` per power-of-two rank bucket."""
    out: Dict[int, int] = {}
    for r in reqs:
        b = rank_bucket(max(1, r.rank))
        out[b] = out.get(b, 0) + value(r)
    return out


class SimServer:
    """State machine advanced by the cluster simulator's event loop."""

    def __init__(self, server_id: int, model: ServerModel,
                 bank_mode: str = "padded", decode_block: int = 1,
                 tracer=None):
        self.sid = server_id
        self.model = model
        self.bank_mode = bank_mode
        # mirrors ServingEngine(decode_block=): decode iterations are
        # dispatched k at a time, amortizing the per-dispatch floor
        self.decode_block = decode_block
        # obs.Tracer: iteration spans carry the already-charged cost as
        # attrs["predicted"] so the drift meter never re-runs the model
        # in the sim hot loop (sim drift is exactly 0 by construction)
        self.tracer = tracer
        self._track = f"server:{server_id}"
        # staged decode span: contiguous same-batch decode iterations
        # coalesce into one span ([start, end, predicted, batch, iters])
        # — mirrors the engine's decode_steps(k) emitting iters=k, and
        # keeps tracing cost off the per-iteration hot path
        self._dec_span: Optional[list] = None
        self.waiting: List[SimRequest] = []
        self.running: List[SimRequest] = []
        self.finished: List[SimRequest] = []   # completion feed; the
        # event loop drains this into telemetry/SLO trackers
        self.busy_until: float = 0.0
        self.iterations = 0
        self.prefill_tokens = 0
        self.busy_time = 0.0

    # -- iteration costs (bank-layout aware) ------------------------------
    def _remote_surcharge(self, reqs: List[SimRequest], now: float
                          ) -> float:
        """GDR remote-read tax: requests whose adapter still lives on a
        peer (local warm copy lands at ``remote_until``) stream weights
        over the fabric each iteration."""
        return sum(r.remote_penalty for r in reqs
                   if now < r.remote_until)

    def _prefill_cost(self, batch: List[SimRequest], tokens: int,
                      now: float = 0.0) -> float:
        pen = self._remote_surcharge(batch, now)
        if self.bank_mode == "bucketed":
            return pen + self.model.prefill_time_bucketed(
                _bucket_sums(batch, lambda r: r.prompt_len))
        return pen + self.model.prefill_time(tokens,
                                             max(r.rank for r in batch))

    def _decode_cost(self, running: List[SimRequest],
                     now: float = 0.0) -> float:
        pen = self._remote_surcharge(running, now)
        if self.bank_mode == "bucketed":
            return pen + self.model.decode_time_bucketed(
                _bucket_sums(running, lambda r: 1),
                steps=self.decode_block)
        return pen + self.model.decode_time(len(running),
                                            max(r.rank for r in running),
                                            steps=self.decode_block)

    # -- load introspection (used by Toppings routing) --------------------
    def estimated_work(self, now: float) -> float:
        """Seconds of outstanding work: queued prefills + remaining decode."""
        w = max(0.0, self.busy_until - now)
        for r in self.waiting:
            w += self._prefill_cost([r], r.prompt_len, now)
        if self.running:
            remaining = max((r.output_len - r.decoded) for r in self.running)
            w += remaining * self._decode_cost(self.running, now) / \
                max(1, len(self.running))
        return w

    def enqueue(self, req: SimRequest) -> None:
        self.waiting.append(req)

    def has_work(self, now: float) -> bool:
        return bool(self.running) or any(r.ready <= now for r in self.waiting)

    def next_event_time(self, now: float) -> Optional[float]:
        if self.busy_until > now:
            return self.busy_until
        if self.running:
            return now
        ready = [r.ready for r in self.waiting]
        if not ready:
            return None
        t = min(ready)
        return max(t, now)

    def flush_spans(self) -> None:
        """Emit the staged decode span (a run of contiguous same-batch
        decode iterations coalesced into one span with ``iters=N`` —
        the same shape the engine's ``decode_steps(k)`` emits)."""
        st = self._dec_span
        if st is None or self.tracer is None:
            return
        self._dec_span = None
        self.tracer.record(
            "decode", st[0], st[1], cat="iteration", track=self._track,
            attrs={"predicted": st[2], "batch": st[3],
                   "steps": self.decode_block, "iters": st[4],
                   "bank_mode": self.bank_mode})

    def step(self, now: float) -> float:
        """Run one iteration starting at `now`; returns its finish time.
        Prefill-prioritized (matches S-LoRA's scheduler)."""
        ready = [r for r in self.waiting if r.ready <= now]
        if ready and len(self.running) < self.model.max_decode_batch:
            batch: List[SimRequest] = []
            tokens = 0
            for r in sorted(ready, key=lambda r: r.ready):
                if tokens + r.prompt_len > self.model.max_batch_tokens \
                        and batch:
                    break
                if len(self.running) + len(batch) >= \
                        self.model.max_decode_batch:
                    break
                batch.append(r)
                tokens += r.prompt_len
            if batch:
                t_iter = self._prefill_cost(batch, tokens, now)
                end = now + t_iter
                for r in batch:
                    self.waiting.remove(r)
                    r.prefill_start = now
                    r.prefill_done = end
                    r.decoded = 1        # first token out of prefill
                    if r.output_len <= 1:
                        r.finish = end
                        self.finished.append(r)
                    else:
                        self.running.append(r)
                self.iterations += 1
                self.prefill_tokens += tokens
                self.busy_time += t_iter
                self.busy_until = end
                if self.tracer is not None:
                    self.flush_spans()
                    self.tracer.record(
                        "prefill", now, end, cat="iteration",
                        track=self._track,
                        attrs={"predicted": t_iter, "tokens": tokens,
                               "batch": len(batch),
                               "bank_mode": self.bank_mode})
                return end
        if self.running:
            t_iter = self._decode_cost(self.running, now)
            end = now + t_iter
            if self.tracer is not None:
                # stage rather than record: back-to-back decode
                # iterations at the same batch size extend the staged
                # span instead of paying the full record cost per iter
                st = self._dec_span
                if st is not None and st[3] == len(self.running) \
                        and now - st[1] <= 1e-12:
                    st[1] = end
                    st[2] += t_iter
                    st[4] += 1
                else:
                    if st is not None:
                        self.flush_spans()
                    self._dec_span = [now, end, t_iter,
                                      len(self.running), 1]
            done = []
            for r in self.running:
                r.decoded += 1
                if r.decoded >= r.output_len:
                    r.finish = end
                    done.append(r)
            for r in done:
                self.running.remove(r)
            self.finished.extend(done)
            self.iterations += 1
            self.busy_time += t_iter
            self.busy_until = end
            return end
        # nothing ready: idle until next request becomes ready
        nxt = self.next_event_time(now)
        return nxt if nxt is not None else now
