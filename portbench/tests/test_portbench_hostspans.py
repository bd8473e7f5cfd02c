"""The readers of the program's host spans (``portbench/hostspans.py``) on
synthetic runs, a traced run of each cell at the tiny sizes on the CPU,
and, on the card, the clock the spans share with the device trace."""
import dataclasses
import time

import pytest
import torch

from portbench import devtrace, harness, hostspans
from portbench.tests.tiny import tiny_cell

CELLS = ["qwen2.5-32b-l32.batch", "deepseek-v2-lite-16b.batch"]
NEW = ["decode_launch_ms", "lora_host_ms", "facade_share",
       "launch_idle_share"]
EPOCH_NS = 1_700_000_000 * 10 ** 9       # the Unix time of cluster time 0


@dataclasses.dataclass
class S:
    name: str
    cat: str
    start: float
    end: float
    track: str = "server:0"
    attrs: dict = dataclasses.field(default_factory=dict)


def clock(t, drift_ns=0):
    return S("clock", "clock", t, t, "control",
             {"unix_ns": EPOCH_NS + int(t * 1e9) + drift_ns})


def us(t):
    """Cluster time t as a profiler time (µs since the Unix epoch)."""
    return (EPOCH_NS + t * 1e9) / 1e3


def ctx_of(spans, ops=(), kind="NVIDIA H100 80GB HBM3",
           t_open=0.0, t_close=10.0, trace_span=(10.0, 20.0)):
    trace = devtrace.Trace([("k", us(s), us(e)) for s, e in ops], [],
                           trace_span[1] - trace_span[0])
    return harness.Context(None, None, kind, t_open, t_close, [],
                           spans=list(spans), trace=trace,
                           trace_span=trace_span)


def block(t, launch, sync, lora=0.0, steps=4):
    """A decode block at t: its iteration span and its two host spans."""
    return [S("decode", "iteration", t, t + launch + sync,
              attrs={"steps": steps}),
            S("decode.launch", "host", t, t + launch,
              attrs={"host_s": {"lora": lora}, "calls": {"lora": 1}}),
            S("decode.sync", "host", t + launch, t + launch + sync)]


def test_launch_time_and_lora_per_step():
    spans = block(1.0, 0.3, 0.1, lora=0.02) + block(2.0, 0.5, 0.1,
                                                    lora=0.04)
    spans += block(12.0, 9.0, 1.0)          # after the window: not read
    ctx = ctx_of(spans)
    assert hostspans.decode_launch_ms(ctx) == pytest.approx(1e3 * 0.8 / 8)
    assert hostspans.lora_host_ms(ctx) == pytest.approx(1e3 * 0.06 / 8)


def test_facade_share_takes_out_the_engine_spans_once():
    # a poll of 1 s holding a decode span of 0.6 s whose two host children
    # nest in it, and a finish of 0.1 s: 0.3 s of the facade's own
    spans = block(1.0, 0.5, 0.1) + [
        S("finish", "host", 1.6, 1.7),
        S("poll", "host", 0.9, 1.9, "control", {"idle_polls": 0})]
    assert hostspans.facade_share(ctx_of(spans)) == pytest.approx(3.0)


def test_a_gap_inside_a_launch_counts_and_one_outside_does_not():
    snaps = [clock(10.0), clock(15.0)]
    # launch [11, 12]: the device runs [11.0, 11.4] and [11.7, 13]; the
    # gap [12.5, 13.5] lies outside every launch
    spans = snaps + [S("decode.launch", "host", 11.0, 12.0),
                     S("prefill.launch", "host", 13.6, 13.8)]
    ops = [(11.0, 11.4), (11.7, 13.0), (13.5, 13.6), (13.7, 19.0)]
    ctx = ctx_of(spans, ops)
    # idle inside launches: [11.4, 11.7] and [13.6, 13.7]
    assert hostspans.launch_idle_share(ctx) == pytest.approx(
        100 * 0.4 / 10)
    from portbench.readers import idle_share
    assert hostspans.launch_idle_share(ctx) <= idle_share(ctx)


def test_mapping_takes_the_nearest_snapshot():
    # the Unix clock runs 2 ms ahead from the second snapshot on: an
    # operation near it is mapped by it, one near the first by the first
    snaps = [clock(10.0), clock(15.0, drift_ns=2_000_000)]
    near_first = us(11.0)
    near_second = us(15.5) + 2_000
    assert hostspans.to_cluster(hostspans.snapshots(snaps),
                                near_first) == pytest.approx(11.0)
    assert hostspans.to_cluster(hostspans.snapshots(snaps),
                                near_second) == pytest.approx(15.5)
    ctx = ctx_of(snaps, [(15.5 + 0.002, 16.0 + 0.002)])
    (_, s, e), = hostspans.device_ops_on_cluster(ctx)
    assert (s, e) == (pytest.approx(15.5), pytest.approx(16.0))


def test_readers_return_none_where_the_program_has_no_such_spans():
    # what a program without host spans records: iteration spans only
    spans = [s for s in block(1.0, 0.3, 0.1) if s.cat == "iteration"]
    ctx = ctx_of(spans, [(11.0, 12.0)])
    assert [getattr(hostspans, m)(ctx) for m in NEW] == [None] * 4
    # launches but no snapshots: nothing maps the device trace
    ctx = ctx_of(block(11.0, 0.3, 0.1), [(11.0, 12.0)])
    assert hostspans.launch_idle_share(ctx) is None
    # launches without part counters: no LoRA reading
    spans = block(1.0, 0.3, 0.1)
    spans[1].attrs = {}
    assert hostspans.lora_host_ms(ctx_of(spans)) is None
    assert hostspans.launch_idle_share(ctx_of(
        [clock(10.0)] + block(11.0, 0.3, 0.1), [(11.0, 12.0)],
        kind="cpu")) is None


@pytest.mark.parametrize("workload", CELLS)
def test_traced_tiny_run_reads_the_span_metrics(workload):
    """A traced run at the tiny sizes: the span metrics read, the launch
    within the step; no device trace on the CPU."""
    cell = tiny_cell(workload)
    out = harness.run_cell(cell, 2 ** 31 + 5, 1.2, True, "cpu")
    got = {k.split(".")[0]: v["value"] for k, v in out["metrics"].items()}
    assert {"decode_launch_ms", "lora_host_ms", "facade_share"} <= set(got)
    assert "launch_idle_share" not in got
    assert 0 < got["lora_host_ms"] < got["decode_launch_ms"] <= \
        got["decode_step_ms"]
    assert 0 < got["facade_share"] < 100


@pytest.mark.cuda
def test_profiler_times_share_the_snapshots_epoch(card):
    """A sleep kernel launched inside a host span, profiled as the
    benchmark profiles: mapped onto the cluster clock by the snapshots,
    it starts after the span's start, within 1 ms of its launch, and ends
    before the sync returns, within 1 ms of it."""
    from repro_torch.obs import Tracer
    from repro_torch.obs.host import PollSpans
    tracer = Tracer()
    snaps = PollSpans(tracer, tracer.now)
    torch.cuda._sleep(1000)
    torch.cuda.synchronize(card)
    snaps.snapshot()
    prof = devtrace.start()
    time.sleep(0.05)
    t0 = tracer.now()
    torch.cuda._sleep(int(2e7))              # ~10 ms at the card's clock
    t_launched = tracer.now()
    torch.cuda.synchronize(card)
    t1 = tracer.now()
    time.sleep(0.05)
    tr = devtrace.finish(prof, t1 - t0)
    snaps.snapshot()
    # the sleep (``spin_kernel``) is the one long operation
    sleeps = [op for op in tr.device_ops if op[2] - op[1] > 5e3]
    assert len(sleeps) == 1, tr.device_ops
    _, s, e = sleeps[0]
    m = hostspans.snapshots(tracer.spans)
    cs, ce = hostspans.to_cluster(m, s), hostspans.to_cluster(m, e)
    assert t0 <= cs and ce <= t1
    assert cs - t_launched < 1e-3 and t1 - ce < 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_traced_slice_maps_inside_its_cluster_times(workload, card,
                                                    monkeypatch):
    """A traced run at the tiny sizes on the card: every device operation
    of the slice, mapped by the snapshots, lies inside the slice's
    cluster times to within 1 ms, and the launches' idle time is a part
    of the slice's."""
    seen = {}
    read = harness.read_metric

    def keep(name, ctx):
        seen["ctx"] = ctx
        return read(name, ctx)
    monkeypatch.setattr(harness, "read_metric", keep)
    out = harness.run_cell(tiny_cell(workload), 2 ** 31 + 5, 4.0, True,
                           card)
    ctx = seen["ctx"]
    ops = hostspans.device_ops_on_cluster(ctx)
    t0, t1 = ctx.trace_span
    assert ops and all(t0 - 1e-3 <= s <= e <= t1 + 1e-3 for _, s, e in ops)
    got = {k.split(".")[0]: v["value"] for k, v in out["metrics"].items()}
    assert 0 < got["launch_idle_share"] <= got["device_idle_share"]
