"""PyTorch port, span layer (``repro_torch.obs``): the request span tree
on the engine substrate (the port's torch engines through
``LoRAServeCluster``, wall clock) against the JAX package's engines and
the simulated substrate, and the tracer, exports, cost-model drift,
flight recorder and Prometheus rendering against the JAX package's on the
same spans. On the reduced llama-7b-paper in fp32, base weights made in
JAX and bridged, nonzero seeded adapter weights on both sides.

Engine criteria are the JAX package's (``tests/test_obs.py``): the same
span vocabulary as the simulator's, every finished request's phases
(``REQUEST_PHASES``) within 1% of its root; tokens as the JAX facade's.
"""
import json
import math
import os
import random
import time

import pytest

from _torch_jax_side import JaxSeededBackend, plain, seeded_setup
from repro.cluster import NetworkModel as JNetworkModel
from repro.cluster.costmodel import ServerModel as JServerModel
from repro.core import AdapterInfo as JAdapterInfo
from repro.core import ServeRequest as JServeRequest
from repro.obs import FlightRecorder as JFlightRecorder
from repro.obs import Span as JSpan
from repro.obs import Tracer as JTracer
from repro.obs import WallClock as JWallClock
from repro.obs import EventClock as JEventClock
from repro.obs import predict_span_seconds as jpredict
from repro.obs import to_perfetto as jto_perfetto
from repro.serving import LoRAServeCluster as JCluster
from repro_torch.cluster import NetworkModel
from repro_torch.cluster.costmodel import ServerModel
from repro_torch.controlplane import TelemetryHub
from repro_torch.core import AdapterInfo, ServeRequest
from repro_torch.launch.serve import SeededWeightsBackend
from repro_torch.obs import (REQUEST_PHASES, EventClock, FlightRecorder,
                             Span, Tracer, WallClock, predict_span_seconds,
                             record_request_spans, to_perfetto, write_jsonl,
                             write_perfetto)
from repro_torch.serving import ClusterReport, LoRAServeCluster, SimBackend
from repro_torch.server.prom import render_metrics

ADAPTERS = (("ea-r8", 8), ("eb-r16", 16))


def _adapters(cls=AdapterInfo):
    return [cls(aid, r, nbytes=r << 20) for aid, r in ADAPTERS]


def _trace(cls=ServeRequest, vocab=None, n=6, prompt_len=6, output_len=4):
    """The JAX obs test's facade trace, 6 requests over the two adapters,
    but all due at once: the engines' batches (and so every row's
    numerics) then do not depend on either host's speed. Concrete prompts
    when ``vocab`` is given."""
    rng = random.Random(7)
    out = []
    for i in range(n):
        aid, rank = ADAPTERS[i % 2]
        prompt = None if vocab is None else [
            rng.randrange(1, vocab) for _ in range(prompt_len)]
        out.append(cls(req_id=i, adapter_id=aid, rank=rank,
                       prompt_len=prompt_len, output_len=output_len,
                       prompt=prompt, arrival=0.0))
    return out


def _request_trees(tracer):
    """{req_id: (root span, {phase: child span})} of finished requests."""
    trees = {}
    for rid, spans in tracer.by_request().items():
        roots = [s for s in spans if s.name == "request"]
        if roots:
            assert len(roots) == 1
            trees[rid] = (roots[0], {s.name: s for s in spans
                                     if s.parent_id == roots[0].span_id})
    return trees


@pytest.fixture(scope="module")
def runs():
    """The JAX facade and the port's over 2 engines each (wall-clock
    tracers), and the port's facade over ``SimBackend`` (event clock), on
    the same trace."""
    cfg, jp, tp, jw, tw = seeded_setup(dict(ADAPTERS))
    common = dict(max_batch=2, max_len=40, seed=0)
    kw = dict(policy="loraserve", rebalance_period=1e9, seed=0)
    jt, tt = JTracer(clock=JWallClock()), Tracer(clock=WallClock())
    jc = JCluster(JaxSeededBackend(cfg, jp, 2, weights=jw, **common),
                  _adapters(JAdapterInfo), network=JNetworkModel(),
                  tracer=jt, **kw)
    tc = LoRAServeCluster(
        SeededWeightsBackend(cfg, tp, 2, weights=tw, device="cpu", **common),
        _adapters(), network=NetworkModel(), tracer=tt, **kw)
    jtrace = _trace(JServeRequest, cfg.vocab_size)
    ttrace = _trace(ServeRequest, cfg.vocab_size)
    jrep, trep = jc.run(jtrace), tc.run(ttrace)
    st = Tracer(clock=EventClock())
    srep = LoRAServeCluster(SimBackend(2), _adapters(), network=NetworkModel(),
                            tracer=st, **kw).run(_trace())
    return dict(jax=(jrep, jt, jtrace), port=(trep, tt, ttrace),
                sim=(srep, st, None), cluster=tc, setup=(cfg, tp, tw))


def test_engine_span_names_equal_the_jax_engines_and_the_sims(runs):
    # the categories the three record alike; the port's own host spans
    # and clock snapshots (``obs/host.py``) are held below
    names = {k: {s.name for s in runs[k][1].spans
                 if s.cat not in PORT_ONLY}
             for k in ("jax", "port", "sim")}
    assert names["port"] == names["jax"] == names["sim"]
    assert {"request", "route", *REQUEST_PHASES} <= names["port"]


PORT_ONLY = ("host", "clock")
HOST_SPANS = {"admit", "prefill.launch", "prefill.sync", "prefill.merge",
              "decode.launch", "decode.sync", "finish", "poll"}


def test_port_host_spans_and_clock_snapshots(runs):
    """The port's engines and facade add host spans and clock snapshots,
    which neither the JAX package's engines nor the simulator under the
    port's facade record. Snapshots are instants on the control track,
    a second apart at least, their Unix time read beside the cluster
    clock; every poll span holds an engine span."""
    spans = runs["port"][1].spans
    assert {s.name for s in spans if s.cat == "host"} == HOST_SPANS
    assert not any(s.cat in PORT_ONLY for k in ("jax", "sim")
                   for s in runs[k][1].spans)
    clocks = [s for s in spans if s.cat == "clock"]
    assert clocks and {s.name for s in clocks} == {"clock"}
    assert all(s.track == "control" and s.start == s.end for s in clocks)
    starts = [s.start for s in clocks]
    assert all(b - a >= 1.0 for a, b in zip(starts, starts[1:]))
    cluster = runs["cluster"]
    offset = time.time_ns() / 1e9 - cluster.clock()
    for s in clocks:
        assert abs(s.attrs["unix_ns"] / 1e9 - s.start - offset) < 0.05
    polls = [s for s in spans if s.name == "poll"]
    engine = [s for s in spans if s.track.startswith("server:")]
    assert polls and all(p.track == "control" for p in polls)
    for p in polls:
        assert any(p.start <= e.start and e.end <= p.end for e in engine)


def test_no_host_spans_without_a_tracer(runs, monkeypatch):
    """A facade over the port's engines without a tracer keeps no poll
    spans, its engines none, and the model finds no part slot."""
    from repro_torch.models import model as TM
    from repro_torch.obs import host as obs_host
    cfg, tp, tw = runs["setup"]
    seen = []
    step = TM.decode_step

    def watched(*a, **kw):
        seen.append(obs_host.PARTS)
        return step(*a, **kw)
    monkeypatch.setattr(TM, "decode_step", watched)
    tc = LoRAServeCluster(
        SeededWeightsBackend(cfg, tp, 2, weights=tw, device="cpu",
                             max_batch=2, max_len=40, seed=0),
        _adapters(), network=NetworkModel(), policy="loraserve",
        rebalance_period=1e9, seed=0)
    assert tc.run(_trace(ServeRequest, cfg.vocab_size, n=2)).completed() == 2
    assert tc._poll_spans is None
    assert all(e.tracer is None for e in tc.backend.engines if e is not None)
    assert seen and all(p is None for p in seen)


def test_poll_spans_count_idle_polls_and_space_snapshots():
    """A poll in which no engine recorded a span records none; the next
    poll span counts it. A snapshot is taken at the first poll, then at
    most once a second."""
    from repro_torch.obs.host import PollSpans
    clock = EventClock()
    tracer = Tracer(clock=clock)
    polls = PollSpans(tracer, clock.now)
    for t, work in ((0.0, False), (0.4, True), (0.8, False), (0.9, False),
                    (1.2, True), (1.5, True)):
        clock.advance(t)
        polls.open()
        if work:
            tracer.record("decode", t, t + 0.05, cat="iteration",
                          track="server:0", attrs={})
        clock.advance(t + 0.1)
        polls.close()
    got = [(s.name, s.start, s.attrs) for s in tracer.spans
           if s.cat != "iteration"]
    assert [g[:2] for g in got] == [("clock", 0.0), ("poll", 0.4),
                                    ("clock", 1.2), ("poll", 1.2),
                                    ("poll", 1.5)]
    assert [a["idle_polls"] for n, _, a in got if n == "poll"] == [1, 2, 0]


def test_host_parts_take_nested_parts_out_of_the_outer_one():
    from repro_torch.obs.host import HostParts
    t = [0.0]

    def tick(dt):
        t[0] += dt
    parts = HostParts(lambda: t[0])

    def attention():
        tick(1.0)
        parts.run("lora", tick, 0.25)
        parts.run("lora", tick, 0.25)
        tick(2.0)
    parts.run("attention", attention)
    parts.timed("ffn", tick)(4.0)
    assert parts.attrs() == {
        "host_s": {"attention": 3.0, "lora": 0.5, "ffn": 4.0},
        "calls": {"attention": 1, "lora": 2, "ffn": 1}}


def test_engine_tokens_equal_the_jax_facades(runs):
    (jrep, _, jtrace), (trep, _, ttrace) = runs["jax"], runs["port"]
    assert trep.completed() == jrep.completed() == len(ttrace)
    assert [list(r.output) for r in ttrace] == \
        [list(r.output) for r in jtrace]
    assert all(len(r.output) == 4 for r in ttrace)


def test_engine_decomposition_within_one_percent(runs):
    report, tracer, _ = runs["port"]
    trees = _request_trees(tracer)
    assert len(trees) == report.completed() > 0
    for root, kids in trees.values():
        assert set(kids) == set(REQUEST_PHASES)
        total = sum(kids[p].duration for p in REQUEST_PHASES)
        assert root.duration > 0
        assert abs(total - root.duration) / root.duration < 0.01


def test_engine_spans_ride_on_the_cluster_clock(runs):
    """Every iteration span lies inside the run, on the backend's wall
    clock, and names its server's track; the engines got the tracer."""
    report, tracer, _ = runs["port"]
    cluster = runs["cluster"]
    assert all(e.tracer is tracer for e in cluster.backend.engines
               if e is not None)
    its = [s for s in tracer.spans if s.cat == "iteration"]
    assert {s.name for s in its} == {"prefill", "decode"}
    end = cluster.clock()
    for s in its:
        assert 0.0 <= s.start <= s.end <= end
        assert s.track in ("server:0", "server:1")


def test_engine_drift_pairs_measured_with_model(runs):
    drift = runs["port"][0].cost_drift
    assert set(drift) >= {"prefill", "decode"}
    for phase in ("prefill", "decode"):
        d = drift[phase]
        assert d["count"] > 0
        assert d["modeled_s"] > 0 and d["measured_s"] > 0
        assert math.isfinite(d["bias"])


# ---------------------------------------------------------------------
# the tracer, exports, drift, flight recorder and /metrics on the same
# spans as the JAX package's
# ---------------------------------------------------------------------
def _seeded_spans(span_cls, seed=0, n=40):
    """Seeded spans of every kind the stack records, iteration spans with
    the batch-shape attributes the engine and the simulator give them."""
    rng = random.Random(seed)
    out, t = [], 0.0
    for i in range(n):
        t += rng.random() * 0.01
        kind = rng.choice(["prefill", "decode", "decode-bucketed", "route",
                           "sim-decode"])
        attrs = {"bank_mode": "padded", "batch": rng.randrange(1, 9),
                 "max_rank": rng.choice([8, 16, 64, 128])}
        name = kind.split("-")[0]
        if kind == "prefill":
            attrs["tokens"] = attrs["batch"] * rng.randrange(16, 512)
        elif kind == "decode":
            attrs["steps"] = attrs["iters"] = rng.choice([1, 4])
        elif kind == "decode-bucketed":
            attrs.update(bank_mode="bucketed", steps=1, iters=1,
                         buckets={8: 2, 64: rng.randrange(1, 4)})
        elif kind == "sim-decode":
            attrs["predicted"] = rng.random() * 0.02
        cat = "gateway" if name == "route" else "iteration"
        out.append(span_cls(name, t, t + rng.random() * 0.03, cat=cat,
                            track=f"server:{i % 2}", req_id=i % 7,
                            span_id=i + 1, attrs=attrs))
    return out


def test_predict_span_seconds_equals_the_jax_packages():
    tm, jm = ServerModel(), JServerModel()
    got = [predict_span_seconds(tm, s) for s in _seeded_spans(Span)]
    want = [jpredict(jm, s) for s in _seeded_spans(JSpan)]
    assert got == want
    assert any(g is None for g in got) and any(g for g in got)


def test_predict_span_seconds_shapes():
    model = ServerModel()
    pre = Span("prefill", 0.0, 1.0, cat="iteration", track="server:0",
               attrs={"tokens": 256, "max_rank": 16, "batch": 2,
                      "bank_mode": "padded"})
    dec = Span("decode", 0.0, 1.0, cat="iteration", track="server:0",
               attrs={"batch": 2, "max_rank": 16, "steps": 4,
                      "iters": 4, "bank_mode": "padded"})
    assert math.isclose(predict_span_seconds(model, pre),
                        model.prefill_time(256, 16))
    assert math.isclose(predict_span_seconds(model, dec),
                        4 * model.decode_time(2, 16, steps=4))
    pre.attrs["predicted"] = 0.123
    assert predict_span_seconds(model, pre) == 0.123
    assert predict_span_seconds(model, Span(
        "route", 0.0, 0.0, cat="gateway", track="control")) is None


def _feed(tracer_cls, clock_cls, span_cls):
    """A tracer on an event clock fed the seeded spans through
    ``record``, the clock advanced as it goes."""
    clock = clock_cls()
    tracer = tracer_cls(clock=clock)
    for s in _seeded_spans(span_cls):
        clock.advance(s.end)
        tracer.record(s.name, s.start, s.end, cat=s.cat, track=s.track,
                      req_id=s.req_id, attrs=s.attrs)
    return tracer


def test_tracer_and_exports_equal_the_jax_packages(tmp_path):
    tt = _feed(Tracer, EventClock, Span)
    jt = _feed(JTracer, JEventClock, JSpan)
    assert tt.now() == jt.now() and tt.n_spans == jt.n_spans == 40
    assert plain({k: [s.span_id for s in v]
                  for k, v in tt.by_request().items()}) == \
        plain({k: [s.span_id for s in v] for k, v in jt.by_request().items()})
    assert [s.span_id for s in tt.named("decode")] == \
        [s.span_id for s in jt.named("decode")]
    assert plain(to_perfetto(tt)) == plain(jto_perfetto(jt))


def test_perfetto_golden_schema(runs, tmp_path):
    tracer = runs["port"][1]
    doc = to_perfetto(tracer)
    assert set(doc) == {"traceEvents", "displayTimeUnit"}
    assert doc["displayTimeUnit"] == "ms"
    slices = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    metas = [e for e in doc["traceEvents"] if e["ph"] == "M"]
    assert len(slices) == tracer.n_spans and metas
    for e in slices:
        assert {"name", "cat", "ph", "ts", "dur", "pid", "tid",
                "args"} <= set(e)
        assert e["ts"] >= 0 and e["dur"] >= 0
        assert "span_id" in e["args"]
    for m in metas:
        assert m["name"] == "process_name" and "name" in m["args"]
    path = os.path.join(tmp_path, "run.perfetto.json")
    assert write_perfetto(tracer, path) == tracer.n_spans
    with open(path) as f:
        assert len(json.load(f)["traceEvents"]) == len(doc["traceEvents"])


def test_jsonl_export_round_trip(runs, tmp_path):
    tracer = runs["port"][1]
    path = os.path.join(tmp_path, "spans.jsonl")
    n = write_jsonl(tracer, path)
    with open(path) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    assert len(rows) == n == tracer.n_spans
    assert {"request", *REQUEST_PHASES} <= {r["name"] for r in rows}
    assert all(r["end"] >= r["start"] for r in rows)


def _ring(rec_cls, span_cls):
    rec = rec_cls(capacity=4, min_interval=5.0, max_dumps=2)
    for i in range(10):
        rec.observe(span_cls(f"s{i}", float(i), i + 0.5, track="t"))
    dumps = [rec.dump("first", now=100.0), rec.dump("too-soon", now=101.0),
             rec.dump("second", now=200.0), rec.dump("over-cap", now=300.0)]
    return dumps, rec.n_dumps, rec.suppressed


def test_flight_recorder_ring_rate_limit_and_cap():
    got = _ring(FlightRecorder, Span)
    assert plain(got) == plain(_ring(JFlightRecorder, JSpan))
    dumps, n, suppressed = got
    assert len(dumps[0]["spans"]) == 4          # the newest 4 only
    assert dumps[0]["spans"][-1]["name"] == "s9"
    assert dumps[1] is None and suppressed >= 1  # rate-limited
    assert dumps[2] is not None and dumps[3] is None and n == 2


def test_record_request_spans_skips_unfinished():
    t = Tracer(clock=EventClock())
    r = ServeRequest(req_id=0, adapter_id="a", rank=8, prompt_len=4,
                     output_len=4, arrival=1.0)
    assert record_request_spans(t, r) is None and t.n_spans == 0


def test_prom_renders_histograms_and_drift():
    tracer = Tracer(clock=EventClock())
    cluster = LoRAServeCluster(SimBackend(2), _adapters(),
                               network=NetworkModel(), rebalance_period=1e9,
                               seed=0, tracer=tracer)
    report = cluster.run(_trace(n=10))
    hub = cluster.hub
    text = render_metrics(report, hub.snapshot(cluster.clock()),
                          {"state": "serving"})
    assert "# TYPE repro_ttft_seconds histogram" in text
    assert 'repro_ttft_seconds_bucket{le="+Inf"}' in text
    assert 'repro_costmodel_seconds_total{kind="modeled",phase="prefill"}' \
        in text
    assert 'repro_costmodel_drift_ratio{phase="decode"}' in text
    lines = [ln for ln in text.splitlines()
             if ln.startswith("repro_ttft_seconds_bucket")]
    counts = [int(ln.rsplit(" ", 1)[1]) for ln in lines]
    assert counts == sorted(counts)
    assert counts[-1] == hub.ttft_hist.count == report.completed()


def test_prom_omits_empty_histograms_and_drift():
    empty = ClusterReport(results=[], summary={}, rebalances=0,
                          placements=[], per_server_counts=[],
                          timed_out=0, fetches=0, fetch_bytes=0,
                          max_adapters_per_server=0,
                          total_adapter_bytes=0, memory_profile=[])
    text = render_metrics(empty, TelemetryHub().snapshot(0.0),
                          {"state": "serving"})
    assert "repro_ttft_seconds_bucket" not in text
    assert "repro_costmodel" not in text


def test_engine_backend_set_tracer_reaches_built_engines(runs):
    """``set_tracer`` after the engines were built reaches each of them;
    ``flush_spans`` has nothing staged."""
    be = runs["cluster"].backend
    other = Tracer(clock=WallClock())
    try:
        be.set_tracer(other)
        assert all(e.tracer is other for e in be.engines if e is not None)
        be.flush_spans()
        assert other.spans == []
    finally:
        be.set_tracer(runs["port"][1])
