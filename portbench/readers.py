"""What the metrics' readers (``portbench/metrics/<name>.py``) share: the
counts they read from a run's context (``harness.Context``)."""
from __future__ import annotations

from . import counts


def in_window(ctx, t) -> bool:
    return t is not None and ctx.t_open <= t <= ctx.t_close


def iteration_spans(ctx, name: str):
    return [s for s in ctx.spans if s.name == name and s.cat == "iteration"
            and ctx.t_open <= s.start and s.end <= ctx.t_close]


def decode_step_ms(ctx):
    spans = iteration_spans(ctx, "decode")
    steps = sum(s.attrs["steps"] for s in spans)
    return 1e3 * sum(s.end - s.start for s in spans) / steps if steps \
        else None


def window_flops(ctx) -> int:
    """The model FLOPs the window's work needed: each prompt prefilled in
    it, and each token decoded in it at its own context."""
    c, ref = ctx.cell.config, ctx.ref
    total = 0
    for rec in ctx.records:
        r = rec.req
        p = len(r.prompt)
        if in_window(ctx, r.prefill_start if r.prefill_start >= 0 else None):
            total += counts.prefill_flops(ref, c, p, rec.rank)
        for j in range(max(rec.out_open, 1), rec.out_close):
            total += counts.token_flops(ref, c, p + j, rec.rank)
    return total


def step_mfu(ctx):
    pk = counts.peaks(ctx.kind)
    if pk is None:
        return None
    return 100 * window_flops(ctx) / (ctx.window_s * pk["bf16_flops"])


def lora_roofline(ctx, patterns):
    """The least time of the LoRA work of the iterations the trace covers,
    over the device time of the kernels named by ``patterns``, in %."""
    pk = counts.peaks(ctx.kind)
    if ctx.trace is None or pk is None:
        return None
    busy = ctx.trace.device_time_s(patterns)
    if busy <= 0:
        return None
    ranks = {r.req.adapter_id: r.rank for r in ctx.records}
    dims = ctx.ref.lora_dims(ctx.cell.config).values()
    L = ctx.cell.config["num_hidden_layers"]
    t0, t1 = ctx.trace_span
    bound = 0.0
    for _, start, end, steps in ctx.iters:
        if start < t0 or end > t1:
            continue
        for toks in steps:
            if toks:
                bound += L * sum(counts.lora_call_bound_s(a, b, toks, ranks,
                                                          pk)
                                 for a, b in dims)
    return 100 * bound / busy


def idle_share(ctx):
    if ctx.trace is None or ctx.kind == "cpu":
        return None
    return 100 * (1 - ctx.trace.busy_s / ctx.trace.window_s)
