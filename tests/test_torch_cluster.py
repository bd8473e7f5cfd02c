"""PyTorch port, cluster layer: ``LoRAServeCluster`` over the port's
``EngineBackend`` against the JAX package's facade over its own, on the
reduced ``llama-7b-paper`` in fp32 with the same base weights (made in JAX
and bridged) and the same nonzero adapter weights. Routing, placements,
rebalances, remote reads, a server kill and the tokens must match exactly.

Both facades run with wall-clock backends. Except where a case mirrors the
JAX package's own wall-clock test (no rebalance: routing is then seeded
and time-free), the cases drive ``submit``/``poll(now)`` on a virtual
clock (``launch.serve.drive``), so rebalances and fault times fall at the
same polls on both sides whatever the host's speed.
"""
import copy
import dataclasses
import random
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_jax_side import JaxSeededBackend
from repro.cluster import NetworkModel as JNetworkModel
from repro.configs import get_smoke_config
from repro.core import AdapterInfo as JAdapterInfo
from repro.core import ServeRequest as JServeRequest
from repro.faults import FaultPlan as JFaultPlan
from repro.launch.serve import build_trace as jax_build_trace
from repro.models import model as JM
from repro.serving import LoRAServeCluster as JCluster
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JEngine
from repro_torch import bridge
from repro_torch.cluster import NetworkModel
from repro_torch.core import AdapterInfo, ServeRequest
from repro_torch.faults import FaultPlan
from repro_torch.launch import serve as launch
from repro_torch.serving import (EngineBackend, LoRAServeCluster, Request,
                                 ServingEngine)

# the launcher's adapters ad0-r8 .. ad5-r8, and the kill case's two
RANKS = {**{a.adapter_id: a.rank for a in launch.cluster_adapters(6)},
         "fa-r8": 8, "fb-r16": 16}


@pytest.fixture(scope="module")
def setup():
    cfg = get_smoke_config("llama-7b-paper")
    jp = JM.init_params(cfg, jax.random.PRNGKey(0))
    tp = bridge.params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                                  device="cpu")
    rng = np.random.default_rng(0)
    L, d = cfg.n_layers, cfg.d_model
    w = {aid: {t: {"A": (rng.standard_normal((L, d, r)) * 0.2
                         ).astype(np.float32),
                   "B": (rng.standard_normal((L, r, d)) * 0.2
                         ).astype(np.float32)}
               for t in cfg.lora.targets}
         for aid, r in RANKS.items()}
    jw = {aid: jax.tree.map(jnp.asarray, x) for aid, x in w.items()}
    tw = {aid: bridge.adapter_weights_from_numpy(
        x, device="cpu") for aid, x in w.items()}
    return cfg, jp, tp, jw, tw


def _clusters(setup, adapters, *, max_batch, max_len, seed,
              rebalance_period, bank_mode="padded", access_mode="migrate",
              kill=None):
    """(JAX facade, port facade) over 2 engines each, set up alike;
    ``kill`` = (time, server) adds ``FaultPlan.kill_one``."""
    cfg, jp, tp, jw, tw = setup
    common = dict(max_batch=max_batch, max_len=max_len, seed=0,
                  bank_mode=bank_mode)
    jbe = JaxSeededBackend(cfg, jp, 2, weights=jw, **common)
    tbe = launch.SeededWeightsBackend(cfg, tp, 2, weights=tw, device="cpu",
                                      **common)
    kw = dict(policy="loraserve", rebalance_period=rebalance_period,
              seed=seed, access_mode=access_mode)
    if kill is not None:
        kw.update(detector_window=0.3, durable_ssd=True)
    jc = JCluster(jbe, [JAdapterInfo(**dataclasses.asdict(a))
                        for a in adapters], network=JNetworkModel(),
                  fault_plan=kill and JFaultPlan.kill_one(*kill), **kw)
    tc = LoRAServeCluster(tbe, adapters, network=NetworkModel(),
                          fault_plan=kill and FaultPlan.kill_one(*kill), **kw)
    return jc, tc


def _jax_trace(trace):
    return [JServeRequest(**{f.name: copy.deepcopy(getattr(r, f.name))
                             for f in dataclasses.fields(r)})
            for r in trace]


def _tokens(trace):
    return {r.req_id: list(r.output) for r in trace}


# ---------------------------------------------------------------------
# no rebalance: the JAX package's test_sim_engine_backend_parity trace
# ---------------------------------------------------------------------
def _mini_trace(adapters, vocab, n, prompt_len=6, output_len=3, gap=0.05):
    rng = random.Random(7)
    out = []
    for i in range(n):
        a = adapters[i % len(adapters)]
        prompt = [rng.randrange(1, vocab) for _ in range(prompt_len)]
        out.append(ServeRequest(req_id=i, adapter_id=a.adapter_id,
                                rank=a.rank, prompt_len=prompt_len,
                                output_len=output_len, prompt=prompt,
                                arrival=i * gap))
    return out


def test_facade_parity_without_rebalance(setup):
    adapters = [AdapterInfo(aid, r, nbytes=r * 1000) for aid, r in
                (("ad0-r8", 8), ("ad5-r8", 8), ("ad1-r16", 16),
                 ("ad3-r64", 64))]
    trace = _mini_trace(adapters, setup[0].vocab_size, 6)
    jc, tc = _clusters(setup, adapters, max_batch=2, max_len=16, seed=5,
                       rebalance_period=1e9)
    jt = _jax_trace(trace)
    jres, tres = jc.run(jt), tc.run(trace)
    assert tc.routed == jc.routed
    assert tres.per_server_counts == jres.per_server_counts
    assert tres.completed() == jres.completed() == len(trace)
    assert _tokens(trace) == _tokens(jt)
    assert all(len(r.output) == 3 for r in trace)
    assert tres.memory_profile == jres.memory_profile


# ---------------------------------------------------------------------
# drifting popularity, mid-run rebalances, both bank modes, remote reads
# ---------------------------------------------------------------------
def _drift_adapters():
    return launch.cluster_adapters(6)


def _drift_trace(cfg):
    return launch.build_cluster_trace(_drift_adapters(), cfg, 12, (6, 8), 4,
                                      duration=3.0, seed=0)


def _drive_both(setup, bank_mode, **kw):
    trace = _drift_trace(setup[0])
    jt = _jax_trace(trace)
    jc, tc = _clusters(setup, _drift_adapters(), max_batch=4, max_len=20,
                       seed=0, rebalance_period=1.0, bank_mode=bank_mode,
                       **kw)
    return (launch.drive(jc, jt, 0.25), jc, jt), \
        (launch.drive(tc, trace, 0.25), tc, trace)


@pytest.fixture(scope="module")
def drift_runs(setup):
    return {mode: _drive_both(setup, mode)
            for mode in ("padded", "bucketed")}


@pytest.mark.parametrize("bank_mode", ["padded", "bucketed"])
def test_midrun_rebalance_parity(drift_runs, bank_mode):
    (jrep, jc, jt), (trep, tc, trace) = drift_runs[bank_mode]
    assert trep.rebalances >= 1 and trep.placement_changed()
    assert trep.rebalances == jrep.rebalances
    assert trep.placements == jrep.placements
    assert tc.routed == jc.routed
    assert trep.completed() == jrep.completed() == len(trace)
    for sid in range(2):
        hosted = tc.backend.hosted_adapters(sid)
        assert hosted == jc.backend.hosted_adapters(sid)
        # the bank is padded to the hosted subset's max rank only
        assert trep.memory_profile[sid]["max_rank"] == max(hosted.values())
    assert trep.memory_profile == jrep.memory_profile
    assert tc.backend.bank_rebuilds >= 1
    assert _tokens(trace) == _tokens(jt)
    assert all(len(r.output) == 4 for r in trace)


def test_bank_modes_emit_the_same_tokens(drift_runs):
    padded = _tokens(drift_runs["padded"][1][2])
    assert padded == _tokens(drift_runs["bucketed"][1][2])


def test_remote_read_parity(setup, drift_runs):
    (jrep, jc, jt), (trep, tc, trace) = _drive_both(
        setup, "padded", access_mode="remote-read")
    assert trep.remote_reads >= 1
    assert trep.remote_reads == jrep.remote_reads
    assert tc.routed == jc.routed
    assert _tokens(trace) == _tokens(jt)
    assert _tokens(trace) == _tokens(drift_runs["padded"][1][2])


# ---------------------------------------------------------------------
# kill-a-server (the JAX package's test_engine_kill_a_server_token_parity)
# ---------------------------------------------------------------------
def test_kill_a_server_token_parity(setup):
    cfg = setup[0]
    rng = random.Random(2)
    adapters = [AdapterInfo("fa-r8", 8, nbytes=8 << 20),
                AdapterInfo("fb-r16", 16, nbytes=16 << 20)]
    base = [ServeRequest(
        req_id=i, adapter_id=adapters[i % 2].adapter_id,
        rank=adapters[i % 2].rank, prompt_len=6, output_len=10,
        prompt=[rng.randrange(1, cfg.vocab_size) for _ in range(6)],
        arrival=0.15 * i) for i in range(8)]
    kw = dict(max_batch=2, max_len=48, seed=0, rebalance_period=1e9)
    _, ref_c = _clusters(setup, adapters, **kw)
    ref = copy.deepcopy(base)
    launch.drive(ref_c, ref, 0.05)
    want = _tokens(ref)
    assert all(len(t) == 10 for t in want.values())

    jc, tc = _clusters(setup, adapters, kill=(0.25, 0), **kw)
    chaotic, jt = copy.deepcopy(base), copy.deepcopy(_jax_trace(base))
    trep, jrep = launch.drive(tc, chaotic, 0.05), launch.drive(jc, jt, 0.05)
    assert trep.server_failures == 1 and trep.recoveries == 1
    assert trep.redispatched == jrep.redispatched >= 1
    assert trep.completed() == len(base)
    assert _tokens(chaotic) == want       # token-identical despite the crash
    assert _tokens(jt) == want            # and equal to the JAX facade's


# ---------------------------------------------------------------------
# the engine's completion feed, the backend's refusals, the launcher
# ---------------------------------------------------------------------
def test_drain_completed_matches_jax(setup):
    cfg, jp, tp, jw, tw = setup
    ranks = {"ad0-r8": 8, "ad1-r16": 16}
    outs = []
    for eng, mk in ((JEngine(cfg, jp, ranks, max_batch=2, max_len=16), JRequest),
                    (ServingEngine(cfg, tp, ranks, max_batch=2, max_len=16,
                                   device="cpu"), Request)):
        assert eng.drain_completed() == []
        for i, aid in enumerate(("ad0-r8", "ad1-r16", "ad0-r8")):
            eng.submit(mk(i, aid, [3, 1, 4, i + 1], 2 + i))
        seen = []
        while eng.queue or eng.active:
            eng.step()
            seen.append([r.req_id for r in eng.drain_completed()])
        assert eng.drain_completed() == [] and eng.completed == []
        outs.append(seen)
    assert outs[0] == outs[1]
    assert sorted(sum(outs[1], [])) == [0, 1, 2]


@pytest.mark.parametrize("kw, exc, match", [
    ({"device": "cuda"}, RuntimeError, "device='cpu'"),
    # a mesh is served from inside a world of its ranks
    # (test_torch_mesh_cluster.py); outside one it is refused
    ({"device": "cpu", "mesh_shape": (1, 2)}, RuntimeError,
     "launch.mesh.spawn")])
def test_engine_backend_refusals(setup, kw, exc, match, monkeypatch):
    # "cuda" must raise even on a machine with a card: pretend it has none
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(exc, match=match):
        EngineBackend(setup[0], setup[2], 2, **kw)


def test_cluster_trace_is_the_jax_launchers(setup):
    cfg = setup[0]
    adapters = launch.cluster_adapters(8)
    jads = [JAdapterInfo(**dataclasses.asdict(a)) for a in adapters]
    got = launch.build_cluster_trace(adapters, cfg, 10, (12,), 8, 6.0, 3)
    want = jax_build_trace(jads, cfg, 10, 12, 8, 6.0, 3)
    # the two packages' Phase enums are distinct types: compare values
    fields = lambda r: {**dataclasses.asdict(r), "phase": r.phase.value}
    assert [fields(r) for r in got] == [fields(r) for r in want]


def test_jax_command_line_with_prompt_len_builds_the_same_trace(setup):
    """The JAX launcher's ``--prompt-len N`` is the port's ``--prompt-lens
    N``: the same command line gives the JAX ``build_trace``'s trace."""
    argv = ["--arch", "llama-7b-paper", "--servers", "2", "--adapters", "6",
            "--requests", "10", "--prompt-len", "9", "--max-new", "5",
            "--duration", "2.5", "--seed", "4"]
    args = launch.parse_args(argv + ["--config", "smoke", "--device", "cpu"])
    assert args.prompt_lens == [9]
    assert launch.parse_args(["--prompt-lens", "9"]).prompt_lens == [9]
    adapters = launch.cluster_adapters(args.adapters)
    got = launch.build_cluster_trace(adapters, setup[0], args.requests,
                                     args.prompt_lens, args.max_new,
                                     args.duration, args.seed)
    jads = [JAdapterInfo(**dataclasses.asdict(a)) for a in adapters]
    want = jax_build_trace(jads, setup[0], 10, 9, 5, 2.5, 4)
    fields = lambda r: {**dataclasses.asdict(r), "phase": r.phase.value}
    assert [fields(r) for r in got] == [fields(r) for r in want]
    with pytest.raises(SystemExit):
        launch.parse_args(["--prompt-len", "9", "--prompt-lens", "8,12"])


def test_launcher_serves_through_the_facade(capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", [
        "serve", "--servers", "2", "--config", "smoke", "--device", "cpu",
        "--dtype", "float32", "--requests", "6", "--duration", "1.0",
        "--prompt-lens", "8,12", "--max-new", "4", "--rebalance-period",
        "0.5", "--adapters", "5"])
    launch.main()
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1] == "cluster drained OK"
    assert any(line.startswith("policy=loraserve finished=6/6")
               for line in out)
    assert any(line.startswith("banks: builds=2") for line in out)
