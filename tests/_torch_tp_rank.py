"""Rank side of ``test_torch_tp.py``: the tensor-parallel engine against
the JAX package.

The JAX package's mesh-sharded engine is checked by token parity with
its single-device engine over one adapter lifecycle
(``tests/test_mesh_sharding.py``). ``lifecycle`` is that trace, written
against the engine interface both packages share, so one definition runs
the JAX engine and the port's. ``rank_job`` is what each rank of a
``repro_torch.launch.mesh.spawn`` group runs: it reads numpy inputs from
a pickle that the test wrote, runs them at tp > 1, and writes its own
numpy outputs beside it. This module imports nothing of JAX
(``test_torch_port_rules.py`` scans it), so the spawned ranks, which
import it by name from the parent's ``sys.path``, import no JAX either.
"""
from __future__ import annotations

import pickle
from pathlib import Path

import torch

from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.launch.mesh import make_engine_mesh
from repro_torch.lora.batched import make_lora_cb
from repro_torch.models.model import bank_layer
from repro_torch.serving import Request, ServingEngine
from repro_torch.serving.sharding import EngineSharding

RANKS = {"a-r8": 8, "b-r64": 64}
LATE = ("c-r16", 16)          # installed mid-flight, then evicted


def lifecycle(engine, make_request, weights):
    """Serve the lifecycle trace on ``engine`` (made with ``RANKS``):
    batched prefill, decode, a mid-flight install of ``LATE`` while
    requests are co-batched, traffic on it, its eviction, more traffic.
    ``weights[adapter]`` (the engine's own tensor type) go over the bank
    after every rebuild, as a fresh bank's B is zero. ``make_request(id,
    adapter, prompt, max_new)`` makes a request. Returns {id: tokens}."""
    def install_all():
        for aid, r in sorted(engine.adapter_ranks.items()):
            engine.install_adapter(aid, r, weights[aid])

    install_all()
    for i in range(4):
        engine.submit(make_request(i, ["a-r8", "b-r64"][i % 2],
                                   list(range(1, 9)), 5))
    engine.step()             # prefill admission
    engine.step()             # some decode progress, slots still live
    if not engine.install_adapter(*LATE):
        raise RuntimeError("the mid-flight install did not rebuild")
    install_all()
    engine.submit(make_request(10, LATE[0], list(range(2, 10)), 5))
    engine.run_until_drained()
    if not engine.evict_adapter(LATE[0]):
        raise RuntimeError("the eviction was refused")
    install_all()
    engine.submit(make_request(11, "b-r64", list(range(3, 11)), 5))
    engine.run_until_drained()
    return {r.req_id: list(r.output) for r in engine.completed}


def _rank_delta(mesh, sharding, cfg, d):
    """This rank's column slice of each target's co-sharded delta at
    layer 0: q gets the full-width x, o the rank's heads of its x."""
    bank = sharding.shard_bank(bridge.bank_from_numpy(cfg, d["bank"],
                                                      device="cpu"))
    cb = make_lora_cb(bank_layer(bank.data, 0), torch.from_numpy(d["idx"]),
                      kernel=d["kernel"], tp=mesh)
    out = {}
    for name, x in d["x"].items():
        x = torch.from_numpy(x)
        if name == "o":
            w = x.shape[-1] // mesh.size
            x = x[..., mesh.rank * w:(mesh.rank + 1) * w]
        out[name] = cb(name, x).numpy()
    return out


def rank_job(rank: int, tp: int, job_path, out_dir) -> None:
    """One rank of a CPU parity run. The job pickle holds ``model`` (a
    smoke config name), ``params`` (the JAX param tree as numpy),
    ``weights`` ({adapter: {target: {"A", "B"}}} numpy), ``cases``
    [(bank_mode, lora_kernel, decode_block)] and ``deltas`` [{"mode",
    "kernel", "bank" (JAX ``LoRABank`` fields as numpy), "idx" (its
    ``lora_idx``), "x" {target: (Bt, S, d_in)}}]. Writes
    ``out_dir/rank{rank}.pkl``: ``shards`` (this rank's sliced params),
    ``delta`` {(mode, kernel, target): column slice}, ``engine`` {case:
    lifecycle tokens} and ``adapter_weights`` (``a-r8`` as the last engine
    gives it to a peer, full width)."""
    with open(job_path, "rb") as f:
        job = pickle.load(f)
    cfg = get_smoke_config(job["model"])
    mesh = make_engine_mesh(1, tp, device="cpu")
    sharding = EngineSharding(mesh, cfg)
    params = bridge.params_from_numpy(cfg, job["params"], device="cpu")
    out = {"shards": {n: p.detach().numpy().copy() for n, p in
                      sharding.shard_params(params).named_parameters()},
           "delta": {}, "engine": {}}
    for d in job["deltas"]:
        for name, y in _rank_delta(mesh, sharding, cfg, d).items():
            out["delta"][(d["mode"], d["kernel"], name)] = y
    weights = {aid: bridge.adapter_weights_from_numpy(w)
               for aid, w in job["weights"].items()}
    for case in job["cases"]:
        mode, kernel, k = case
        eng = ServingEngine(cfg, params, dict(RANKS), max_batch=4,
                            max_len=40, bank_mode=mode, lora_kernel=kernel,
                            decode_block=k, mesh=mesh, device="cpu")
        out["engine"][case] = lifecycle(
            eng, lambda *a: Request(*a, arrival=0.0), weights)
    out["adapter_weights"] = {
        t: {k: v.numpy() for k, v in w.items()}
        for t, w in eng.adapter_weights("a-r8").items()}
    with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
