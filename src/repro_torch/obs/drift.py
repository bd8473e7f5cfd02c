"""A copy of the JAX package's ``obs/drift.py``. In the port the model
is the port's copy of ``cluster/costmodel.py``, a model of the paper's
A100 fleet: on the H100 the drift compares measured H100 spans with that
A100 model, not with a model of the card.

Cost-model drift: per-phase modeled-vs-measured iteration error.

Every per-server ``iteration``-category span (``prefill`` / ``decode``
batches emitted by ``SimServer`` and ``ServingEngine``) is paired with
the ``ServerModel`` predicted time for that exact batch shape. The
``CostModelDrift`` listener accumulates the error per phase so
``/metrics`` and ``ClusterReport`` can expose it — a calibration
regression (wrong ``MFU_PREFILL``, stale ``ICI_BW``, a new kernel the
constants don't know about) shows up as a growing bias instead of
silently skewing routing and autoscaling decisions.

Two prediction paths:

* sim spans carry a precomputed ``attrs["predicted"]`` — the very
  pen+base value the simulator charged, so the listener is a dict
  lookup and drift is exactly 0 (the sim's time *is* the model; a
  nonzero value means the plumbing is broken).
* engine spans carry the raw batch shape (tokens / batch / max_rank /
  steps / buckets / bank_mode) and ``predict_span_seconds`` runs the
  model, so engine drift is the real modeled-vs-measured gap.
"""
from __future__ import annotations

from typing import Dict, Optional

from ..cluster.costmodel import ServerModel
from .trace import Span

PHASES = ("prefill", "decode")


def predict_span_seconds(model: ServerModel, span: Span) -> Optional[float]:
    """ServerModel predicted seconds for one iteration span, from the
    batch-shape attrs the span carries. None when the span isn't an
    iteration or lacks the shape attrs."""
    attrs = span.attrs
    pre = attrs.get("predicted")
    if pre is not None:
        return pre
    if span.name == "prefill":
        buckets = attrs.get("buckets")
        if buckets:
            return model.prefill_time_bucketed(buckets)
        tokens = attrs.get("tokens")
        if tokens is None:
            return None
        return model.prefill_time(tokens, attrs.get("max_rank", 0))
    if span.name == "decode":
        iters = attrs.get("iters", 1)
        steps = attrs.get("steps", 1)
        buckets = attrs.get("buckets")
        if buckets:
            return iters * model.decode_time_bucketed(buckets, steps=steps)
        batch = attrs.get("batch")
        if batch is None:
            return None
        return iters * model.decode_time(
            batch, attrs.get("max_rank", 0), steps=steps)
    return None


class _PhaseStat:
    __slots__ = ("count", "modeled_s", "measured_s", "abs_err_s")

    def __init__(self):
        self.count = 0
        self.modeled_s = 0.0
        self.measured_s = 0.0
        self.abs_err_s = 0.0

    def add(self, modeled: float, measured: float) -> None:
        self.count += 1
        self.modeled_s += modeled
        self.measured_s += measured
        self.abs_err_s += abs(measured - modeled)


class CostModelDrift:
    """Tracer listener accumulating per-phase modeled-vs-measured error
    over ``iteration`` spans. ``summary()`` feeds ``ClusterReport`` and
    the Prometheus exporter."""

    def __init__(self, model: Optional[ServerModel] = None):
        self.model = model if model is not None else ServerModel()
        self.stats: Dict[str, _PhaseStat] = {}
        self.unmatched = 0               # iteration spans we couldn't price

    def observe(self, span: Span) -> None:
        if span.cat != "iteration":
            return
        # fast path: sim spans pre-pay the prediction (attrs lookup, no
        # model call), and the stat update is inlined — this listener
        # runs once per sim iteration, so every function call counts
        modeled = span.attrs.get("predicted")
        if modeled is None:
            modeled = predict_span_seconds(self.model, span)
            if modeled is None:
                self.unmatched += 1
                return
        stat = self.stats.get(span.name)
        if stat is None:
            stat = self.stats[span.name] = _PhaseStat()
        measured = span.end - span.start
        # coalesced decode spans cover `iters` iterations — count them
        # all so iterations_total stays a true per-iteration tally
        stat.count += span.attrs.get("iters", 1)
        stat.modeled_s += modeled
        stat.measured_s += measured
        err = measured - modeled
        stat.abs_err_s += err if err >= 0 else -err

    def summary(self) -> Dict[str, dict]:
        """Per-phase dict: count, modeled_s, measured_s, abs_err_s,
        bias ((measured-modeled)/modeled — signed calibration skew) and
        mean_abs_rel_err (abs_err_s/modeled_s)."""
        out: Dict[str, dict] = {}
        for phase, st in self.stats.items():
            denom = st.modeled_s if st.modeled_s > 0 else 1.0
            out[phase] = {
                "count": st.count,
                "modeled_s": st.modeled_s,
                "measured_s": st.measured_s,
                "abs_err_s": st.abs_err_s,
                "bias": (st.measured_s - st.modeled_s) / denom,
                "mean_abs_rel_err": st.abs_err_s / denom,
            }
        return out
