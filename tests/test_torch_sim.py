"""PyTorch port, simulated substrate: the port's copies of the trace
generators, the discrete-event ``ClusterSimulator`` and ``SimBackend``
under ``LoRAServeCluster`` against the JAX package's on the same seeded
inputs. Both sides are pure Python on an event clock, so everything must
be equal exactly: requests, reports, the span lists (name, category,
start, end, parent, request and attributes), the Perfetto and JSONL
exports, the Prometheus text, the cost-model drift and the flight
recorder's dumps. Also ``serving/scheduler.py:replay`` on the port's
engine against the JAX engine's, token for token."""
import copy
import json
import math
import os

import pytest

from _torch_jax_side import plain, seeded_setup
from repro.cluster import ClusterSimulator as JSimulator
from repro.cluster import NetworkModel as JNetworkModel
from repro.controlplane import ClusterController as JController
from repro.controlplane import ControllerConfig as JControllerConfig
from repro.controlplane import SLOSpec as JSLOSpec
from repro.core import AdapterInfo as JAdapterInfo
from repro.faults import FaultPlan as JFaultPlan
from repro.obs import EventClock as JEventClock
from repro.obs import FlightRecorder as JFlightRecorder
from repro.obs import Tracer as JTracer
from repro.obs import to_perfetto as jto_perfetto
from repro.obs import write_jsonl as jwrite_jsonl
from repro.serving import LoRAServeCluster as JCluster
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JEngine
from repro.serving import SimBackend as JSimBackend
from repro.serving import replay as jreplay
from repro.server.prom import render_metrics as jrender_metrics
from repro import traces as jtraces
from repro_torch import traces as ttraces
from repro_torch.cluster import ClusterSimulator, NetworkModel
from repro_torch.controlplane import (ClusterController, ControllerConfig,
                                      SLOSpec)
from repro_torch.core import AdapterInfo
from repro_torch.faults import FaultPlan
from repro_torch.obs import (REQUEST_PHASES, EventClock, FlightRecorder,
                             Tracer, to_perfetto, write_jsonl)
from repro_torch.serving import (LoRAServeCluster, Request, ServingEngine,
                                 SimBackend, replay)
from repro_torch.server.prom import render_metrics

# the JAX package's side of every name a case uses
JAX = dict(Simulator=JSimulator, NetworkModel=JNetworkModel,
           Controller=JController, ControllerConfig=JControllerConfig,
           SLOSpec=JSLOSpec, AdapterInfo=JAdapterInfo, FaultPlan=JFaultPlan,
           EventClock=JEventClock, FlightRecorder=JFlightRecorder,
           Tracer=JTracer, to_perfetto=jto_perfetto, write_jsonl=jwrite_jsonl,
           Cluster=JCluster, SimBackend=JSimBackend,
           render_metrics=jrender_metrics, traces=jtraces)
PORT = dict(Simulator=ClusterSimulator, NetworkModel=NetworkModel,
            Controller=ClusterController, ControllerConfig=ControllerConfig,
            SLOSpec=SLOSpec, AdapterInfo=AdapterInfo, FaultPlan=FaultPlan,
            EventClock=EventClock, FlightRecorder=FlightRecorder,
            Tracer=Tracer, to_perfetto=to_perfetto, write_jsonl=write_jsonl,
            Cluster=LoRAServeCluster, SimBackend=SimBackend,
            render_metrics=render_metrics, traces=ttraces)


def _spans(tracer):
    return [(s.name, s.cat, s.track, s.start, s.end, s.span_id, s.parent_id,
             s.req_id, plain(s.attrs)) for s in tracer.spans]


def _exports(pkg, tracer, path):
    """The tracer's Perfetto document and its JSONL file's text."""
    pkg["write_jsonl"](tracer, path)
    with open(path) as f:
        return plain(pkg["to_perfetto"](tracer)), f.read()


# ---------------------------------------------------------------------
# trace generators
# ---------------------------------------------------------------------
TRACE_CASES = {
    "uniform": lambda tr, ads: tr.synth_trace(ads, rps=10, duration=30,
                                              arrival="uniform", seed=1),
    "poisson": lambda tr, ads: tr.synth_trace(ads, rps=10, duration=30,
                                              arrival="poisson", seed=1),
    "shifting": lambda tr, ads: tr.synth_trace(
        ads, rps=20, duration=40, popularity="shifting", seed=2),
    "exponential": lambda tr, ads: tr.synth_trace(
        ads, rps=20, duration=40, popularity="exponential", seed=3),
    "powerlaw": lambda tr, ads: tr.synth_trace(
        ads, rps=20, duration=40, popularity="powerlaw", alpha=1.5,
        seed=4),
    "six": lambda tr, ads: tr.six_traces(ads, rps=5, duration=20, seed=5),
    "production": lambda tr, ads: tr.production_trace(
        50, rps=5, duration=60, seed=6),
    "production-rising": lambda tr, ads: tr.production_trace_with_meta(
        100, rps=5, duration=60, seed=7, load_profile="rising"),
}


@pytest.mark.parametrize("case", sorted(TRACE_CASES))
def test_trace_generators_equal_the_jax_packages(case):
    outs = []
    for pkg in (JAX, PORT):
        ads = pkg["traces"].make_adapters(30, alpha=1.0, seed=0)
        outs.append((plain(ads), plain(TRACE_CASES[case](pkg["traces"],
                                                         ads))))
    assert outs[0] == outs[1]
    assert outs[1][1]


# ---------------------------------------------------------------------
# ClusterSimulator
# ---------------------------------------------------------------------
def _sim_run(pkg, policy="loraserve", *, controller=None, recorder=None,
             fault_seed=None, n_servers=3, n_adapters=12, rps=6.0,
             duration=8.0, seed=3, **kw):
    """The JAX obs test's simulator run: synth_trace over make_adapters,
    an ``EventClock`` tracer; ``fault_seed`` adds a random fault plan."""
    tr = pkg["traces"]
    adapters = tr.make_adapters(n_adapters, seed=seed)
    trace = tr.synth_trace(adapters, rps=rps, duration=duration,
                           prompt_len=96, output_len=24, seed=seed)
    tracer = pkg["Tracer"](clock=pkg["EventClock"]())
    if fault_seed is not None:
        kw.update(fault_plan=pkg["FaultPlan"].random_plan(
            fault_seed, horizon=duration, n_servers=n_servers, rate=1.0),
            durable_ssd=True)
    sim = pkg["Simulator"](n_servers, adapters, policy=policy, seed=seed,
                           timeout=120.0, warmup=0.0, rebalance_period=4.0,
                           controller=controller, tracer=tracer,
                           flight_recorder=recorder, **kw)
    return sim.run(trace), tracer


@pytest.mark.parametrize("policy,kw", [
    ("loraserve", {}), ("slora-random", {}), ("slora-contiguous", {}),
    ("toppings", {}), ("loraserve", {"bank_mode": "bucketed",
                                     "decode_block": 4}),
    ("loraserve", {"access_mode": "remote-read", "prefetch": True}),
    ("loraserve", {"fault_seed": 4})],
    ids=["loraserve", "slora-random", "slora-contiguous", "toppings",
         "bucketed", "remote-read", "faults"])
def test_simulator_equals_the_jax_packages(policy, kw, tmp_path):
    (jres, jt), (tres, tt) = (_sim_run(pkg, policy, **kw)
                              for pkg in (JAX, PORT))
    assert tres.completed() > 0 and tt.n_spans > 0
    if "fault_seed" in kw:
        assert tres.server_failures >= 1 and tres.redispatched >= 1
    assert plain(tres) == plain(jres)
    assert _spans(tt) == _spans(jt)
    assert _exports(PORT, tt, tmp_path / "t.jsonl") == \
        _exports(JAX, jt, tmp_path / "j.jsonl")


def test_simulator_span_tree_decomposes_exactly():
    """The JAX obs test's criterion on the port's simulator: no orphan
    spans, children inside their parents, and each finished request's
    phases sum exactly to its root, which is its arrival-to-finish."""
    res, tracer = _sim_run(PORT)
    by_id = {s.span_id: s for s in tracer.spans}
    for s in tracer.spans:
        if s.parent_id is not None:
            parent = by_id[s.parent_id]
            assert parent.start - 1e-9 <= s.start
            assert s.end <= parent.end + 1e-9
    fin = {r.req_id: r for r in res.requests if r.finish >= 0}
    roots = 0
    for rid, spans in tracer.by_request().items():
        root = [s for s in spans if s.name == "request"]
        if not root:
            continue
        roots += 1
        kids = {s.name: s for s in spans if s.parent_id == root[0].span_id}
        assert set(kids) == set(REQUEST_PHASES)
        total = sum(kids[p].duration for p in REQUEST_PHASES)
        assert math.isclose(total, root[0].duration, rel_tol=0,
                            abs_tol=1e-9)
        assert math.isclose(root[0].duration,
                            fin[rid].finish - fin[rid].arrival, rel_tol=0,
                            abs_tol=1e-9)
    assert roots == res.completed()
    for phase in ("prefill", "decode"):     # the sim's time is the model
        assert abs(res.cost_drift[phase]["bias"]) < 1e-9


def _forced_violation(pkg, out_dir):
    """An impossible TTFT target forces an SLO violation."""
    ctrl = pkg["Controller"](
        pkg["SLOSpec"](ttft=1e-4, target=0.99, window=10.0),
        pkg["ControllerConfig"](tick_period=0.5, min_samples=1, patience=1,
                                max_servers=3))
    rec = pkg["FlightRecorder"](capacity=512, out_dir=str(out_dir),
                                min_interval=0.0)
    res, _ = _sim_run(pkg, controller=ctrl, recorder=rec, n_servers=2,
                      n_adapters=8)
    files = {}
    for name in sorted(os.listdir(out_dir)):
        with open(out_dir / name) as f:
            files[name] = json.load(f)
    return plain(res), plain(rec.dumps), files


def test_flight_recorder_dumps_as_the_jax_packages(tmp_path):
    (jtmp, ttmp) = tmp_path / "jax", tmp_path / "port"
    jtmp.mkdir(), ttmp.mkdir()
    jout, tout = _forced_violation(JAX, jtmp), _forced_violation(PORT, ttmp)
    assert tout == jout
    res, dumps, files = tout
    assert dumps and res["flight_dumps"] == len(dumps)
    assert {d["reason"] for d in dumps} & {"slo-violation", "scale-up"}
    assert any(f.endswith(".audit.json") for f in files)
    assert any(f.endswith(".perfetto.json") for f in files)


# ---------------------------------------------------------------------
# SimBackend under the facade
# ---------------------------------------------------------------------
def _facade_run(pkg, bank_mode, tmp_path):
    """``LoRAServeCluster`` over ``SimBackend`` on a synth_trace, with an
    ``EventClock`` tracer: report, spans, exports and /metrics text."""
    tr = pkg["traces"]
    adapters = tr.make_adapters(10, seed=4)
    trace = tr.synth_trace(adapters, rps=8, duration=6, prompt_len=64,
                           output_len=16, popularity="shifting", seed=4)
    tracer = pkg["Tracer"](clock=pkg["EventClock"]())
    backend = pkg["SimBackend"](2, adapter_nbytes={
        a.adapter_id: a.nbytes for a in adapters}, bank_mode=bank_mode)
    cluster = pkg["Cluster"](backend, adapters, policy="loraserve",
                             network=pkg["NetworkModel"](),
                             rebalance_period=2.0, seed=0, tracer=tracer)
    trace = copy.deepcopy(trace)
    report = cluster.run(trace)
    # the telemetry window read at the run's last finish on the event
    # clock (cluster.clock() of a virtual backend is the host's clock)
    end = max(r.finish for r in trace)
    text = pkg["render_metrics"](report, cluster.hub.snapshot(end),
                                 {"state": "serving"})
    return (plain(report), _spans(tracer),
            _exports(pkg, tracer, tmp_path / f"{id(pkg)}.jsonl"), text)


@pytest.mark.parametrize("bank_mode", ["padded", "bucketed"])
def test_sim_backend_facade_equals_the_jax_packages(bank_mode, tmp_path):
    jout = _facade_run(JAX, bank_mode, tmp_path)
    tout = _facade_run(PORT, bank_mode, tmp_path)
    report, spans, _, text = tout
    assert report["rebalances"] >= 1 and spans
    assert "# TYPE repro_ttft_seconds histogram" in text
    assert 'repro_costmodel_drift_ratio{phase="decode"}' in text
    for got, want in zip(tout, jout):
        assert got == want


# ---------------------------------------------------------------------
# replay (serving/scheduler.py) on the engines
# ---------------------------------------------------------------------
def test_replay_tokens_equal_the_jax_packages():
    ranks = {"ra-r8": 8, "rb-r16": 16}
    cfg, jp, tp, jw, tw = seeded_setup(ranks)
    prompts = [[3, 1, 4, 1, 5], [9, 2, 6, 5], [3, 5, 8, 9, 7, 9]]
    outs = []
    for Engine, Req, run, params, weights, kw in (
            (JEngine, JRequest, jreplay, jp, jw, {}),
            (ServingEngine, Request, replay, tp, tw, {"device": "cpu"})):
        eng = Engine(cfg, params, ranks, max_batch=2, max_len=16, **kw)
        for aid, r in ranks.items():
            eng.install_adapter(aid, r, weights[aid])
        # all due at once: the batches (and so every row's numerics)
        # do not depend on either host's speed
        reqs = [Req(i, list(ranks)[i % 2], p, 4, arrival=0.0)
                for i, p in enumerate(prompts)]
        summary = run(eng, reqs, speedup=1.0)
        assert not summary["exhausted"]
        assert summary["finished"] == len(reqs)
        outs.append([list(r.output) for r in reqs])
    assert outs[1] == outs[0]
    assert all(len(o) == 4 for o in outs[1])
