"""PyTorch port, the cluster facade over mesh-sharded servers:
``LoRAServeCluster`` over ``EngineBackend(mesh_shape=(1, 2))`` and
``(2, 1)``, each a gloo world spawned on the CPU (``_torch_tp_rank.
mesh_cluster_job``: every rank builds the backend, rank 0 drives the
facade on the virtual clock, ``launch.serve.drive``, and the others
follow it), on the reduced ``llama-7b-paper`` in fp32 with the weights of
``test_torch_cluster.py`` (made in JAX and bridged):

* a drifting-popularity run with mid-run rebalances and remote reads,
  and a run in which server 0 is killed: routes, per-server counts,
  rebalances, placements, remote reads, the failure and recovery, and
  every token equal the port's single-device facade's and the JAX
  facade's; the report carries the mesh; each bank's bytes are one
  rank's co-sharded slice (half of them at tp = 2);
* the launcher end to end: ``--servers 2 --mesh 1,2`` prints rank 0's
  report, and ``--serve 127.0.0.1:0 --mesh 1,2`` streams a request and
  drains on SIGTERM, its other rank stopped with it.

The worlds run beside the reference facades.
"""
import copy
import dataclasses
import json
import os
import pickle
import random
import signal
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

import _torch_tp_rank as tp_rank
from _torch_jax_side import JaxSeededBackend
from repro.cluster import NetworkModel as JNetworkModel
from repro.configs import get_smoke_config
from repro.core import AdapterInfo as JAdapterInfo
from repro.core import ServeRequest as JServeRequest
from repro.faults import FaultPlan as JFaultPlan
from repro.models import model as JM
from repro.serving import LoRAServeCluster as JCluster
from repro_torch import bridge
from repro_torch.core import AdapterInfo, ServeRequest
from repro_torch.launch import serve as launch
from repro_torch.launch.mesh import spawn

MESHES = [(1, 2), (2, 1)]
RANKS = {**{a.adapter_id: a.rank for a in launch.cluster_adapters(6)},
         "fa-r8": 8, "fb-r16": 16}
ROOT = Path(__file__).resolve().parents[1]


def _scenarios(cfg):
    """The drift run (mid-run rebalances, remote reads) and the kill run,
    as ``_torch_tp_rank.port_facade`` takes them."""
    adapters = launch.cluster_adapters(6)
    drift = dict(
        name="drift", adapters=adapters, max_batch=4, max_len=20, seed=0,
        rebalance=1.0, access_mode="remote-read", dt=0.25,
        trace=launch.build_cluster_trace(adapters, cfg, 12, (6, 8), 4,
                                         duration=3.0, seed=0))
    rng = random.Random(2)
    kill_ads = [AdapterInfo("fa-r8", 8, nbytes=8 << 20),
                AdapterInfo("fb-r16", 16, nbytes=16 << 20)]
    trace = [ServeRequest(
        req_id=i, adapter_id=kill_ads[i % 2].adapter_id,
        rank=kill_ads[i % 2].rank, prompt_len=6, output_len=10,
        prompt=[rng.randrange(1, cfg.vocab_size) for _ in range(6)],
        arrival=0.15 * i) for i in range(8)]
    kill = dict(name="kill", adapters=kill_ads, max_batch=2, max_len=48,
                seed=0, rebalance=1e9, access_mode="migrate", dt=0.05,
                kill=(0.25, 0), trace=trace)
    return [drift, kill]


def _jax_outcome(cfg, jp, jw, sc):
    """The JAX facade on a scenario, as ``cluster_outcome`` reads it."""
    jbe = JaxSeededBackend(cfg, jp, 2, weights=jw,
                           max_batch=sc["max_batch"], max_len=sc["max_len"],
                           seed=0)
    kw = dict(policy="loraserve", rebalance_period=sc["rebalance"],
              seed=sc["seed"], access_mode=sc["access_mode"])
    if sc.get("kill") is not None:
        kw.update(detector_window=0.3, durable_ssd=True,
                  fault_plan=JFaultPlan.kill_one(*sc["kill"]))
    jc = JCluster(jbe, [JAdapterInfo(**dataclasses.asdict(a))
                        for a in sc["adapters"]], network=JNetworkModel(),
                  **kw)
    jt = [JServeRequest(**{f.name: copy.deepcopy(getattr(r, f.name))
                           for f in dataclasses.fields(r)})
          for r in sc["trace"]]
    return tp_rank.cluster_outcome(jc, launch.drive(jc, jt, sc["dt"]), jt)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"jax": [...], "port": [...], (dp, tp): [...]}: each scenario's
    outcome on the JAX facade, the port's single-device facade and each
    mesh; the meshes' worlds run while the references are computed."""
    import jax.numpy as jnp
    tmp = tmp_path_factory.mktemp("mesh_cluster")
    cfg = get_smoke_config("llama-7b-paper")
    jp = JM.init_params(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    L, d = cfg.n_layers, cfg.d_model
    w = {aid: {t: {"A": (rng.standard_normal((L, d, r)) * 0.2
                         ).astype(np.float32),
                   "B": (rng.standard_normal((L, r, d)) * 0.2
                         ).astype(np.float32)}
               for t in cfg.lora.targets}
         for aid, r in RANKS.items()}
    params = jax.tree.map(np.asarray, jp)
    with open(tmp / "job.pkl", "wb") as f:
        pickle.dump({"params": params, "weights": w,
                     "scenarios": _scenarios(cfg)}, f)
    worlds = {}
    for dp, tp in MESHES:
        worlds[(dp, tp)] = spawn(
            tp_rank.mesh_cluster_job, dp * tp, backend="gloo",
            init_file=tmp / f"init{dp}x{tp}", join=False,
            args=(dp, tp, str(tmp / "job.pkl"), str(tmp)))
    out = {"jax": [], "port": []}
    tparams = bridge.params_from_numpy(cfg, params, device="cpu")
    tw = {aid: bridge.adapter_weights_from_numpy(x, device="cpu")
          for aid, x in w.items()}
    jw = {aid: jax.tree.map(jnp.asarray, x) for aid, x in w.items()}
    for sc in _scenarios(cfg):
        out["jax"].append(_jax_outcome(cfg, jp, jw, sc))
        backend = tp_rank.scenario_backend(cfg, tparams, tw, sc)
        cluster = tp_rank.port_facade(backend, sc)
        report = launch.drive(cluster, sc["trace"], sc["dt"])
        out["port"].append(tp_rank.cluster_outcome(cluster, report,
                                                   sc["trace"]))
    for mesh, ctx in worlds.items():
        while not ctx.join():
            pass
        with open(tmp / f"cluster-{mesh[0]}x{mesh[1]}.pkl", "rb") as f:
            out[mesh] = pickle.load(f)
    return out


_SAME = ("routed", "counts", "tokens", "completed", "rebalances",
         "placements", "remote_reads", "failures", "recoveries")


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("case", [0, 1], ids=["drift", "kill"])
def test_mesh_facade_matches_one_device_and_jax(runs, mesh, case):
    got, port, want = runs[mesh][case], runs["port"][case], runs["jax"][case]
    for key in _SAME:
        assert got[key] == port[key] == want[key], key
    assert got["mesh_shape"] == mesh
    assert got["completed"] == len(got["tokens"])
    if case == 0:
        assert got["rebalances"] >= 1 and got["remote_reads"] >= 1
    else:
        assert got["failures"] == got["recoveries"] == 1
        assert all(len(t) == 10 for t in got["tokens"].values())
    # a bank's bytes are what one rank holds: its co-sharded slice
    tp = mesh[1]
    for g, p in zip(got["memory_profile"], port["memory_profile"]):
        assert g["adapter_bytes"] * tp == p["adapter_bytes"]
        assert {k: v for k, v in g.items() if k != "adapter_bytes"} == \
            {k: v for k, v in p.items() if k != "adapter_bytes"}


def test_launcher_serves_the_cluster_on_a_mesh(monkeypatch, capfd):
    monkeypatch.setattr("sys.argv", [
        "serve", "--config", "smoke", "--device", "cpu", "--servers", "2",
        "--mesh", "1,2", "--backend", "gloo", "--requests", "6",
        "--duration", "1", "--dtype", "float32"])
    launch.main()
    out = capfd.readouterr().out
    assert "finished=6/6" in out and "mesh=(1, 2)" in out
    assert out.count("finished=") == 1 and "cluster drained OK" in out


def test_gateway_on_a_mesh_streams_and_drains():
    """``--serve 127.0.0.1:0 --mesh 1,2``: rank 0's gateway streams one
    request; SIGTERM to the launcher drains it and stops rank 1."""
    import http.client
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--serve",
         "127.0.0.1:0", "--mesh", "1,2", "--backend", "gloo", "--device",
         "cpu", "--config", "smoke", "--dtype", "float32"], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env)
    try:
        seen = []
        while not (seen and seen[-1].startswith("listening on ")):
            line = proc.stdout.readline()
            assert line, "".join(seen)
            seen.append(line)
        port = int(seen[-1].rsplit(":", 1)[1])
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        conn.request("POST", "/v1/completions", json.dumps(
            {"adapter_id": "ad0-r8", "prompt_len": 8, "max_tokens": 4}))
        resp = conn.getresponse()
        frames = [json.loads(x[len("data: "):]) for x in
                  resp.read().decode().split("\n\n")
                  if x.startswith("data: {")]
        assert resp.status == 200
        assert sum(len(f.get("tokens", ())) for f in frames) == 4, frames
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, out
    assert "served=1" in out
    assert out.strip().splitlines()[-1] == "gateway drained OK"
