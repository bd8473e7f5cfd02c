"""Rank side of ``test_torch_tp.py`` and ``test_torch_tp_families.py``:
the tensor-parallel engine against the JAX package.

The JAX package's mesh-sharded engine is checked by token parity with
its single-device engine over one adapter lifecycle
(``tests/test_mesh_sharding.py``). ``lifecycle`` is that trace, written
against the engine interface both packages share, so one definition runs
the JAX engine and the port's. ``rank_job`` is what each rank of a
``repro_torch.launch.mesh.spawn`` group runs: it reads numpy inputs from
a pickle that the test wrote, runs them at tp > 1, and writes its own
numpy outputs beside it; ``family_job`` does the same for every family
(layers, a model-level prefill and decode, the engine's tokens). This module imports nothing of JAX
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


# ---------------------------------------------------------------------------
# every family at tp > 1 (``test_torch_tp_families.py``)
# ---------------------------------------------------------------------------
FAMILY_RANKS = {"a-r8": 8, "b-r32": 32, "c-r16": 16}
# (bank_mode, lora_kernel): the engine cases of every family
FAMILY_CASES = [("padded", "einsum"), ("bucketed", "einsum"),
                ("padded", "sgmv"), ("bucketed", "sgmv")]


def family_trace(make_request):
    """Four prompts of 8 tokens (a prefill group that every tp divides:
    the MoE families take the expert-parallel path), then two of 6 (tp =
    2 divides them, tp = 4 does not: the drop-free path), 4 new tokens
    each, over the three adapters."""
    aids = sorted(FAMILY_RANKS)
    reqs = [make_request(i, aids[i % 3], [(5 * i + 3 * t) % 97 + 1
                                         for t in range(8)], 4)
            for i in range(4)]
    reqs += [make_request(4 + i, aids[(i + 1) % 3],
                          [(7 * i + 2 * t) % 89 + 1 for t in range(6)], 4)
             for i in range(2)]
    return reqs


def serve_family(engine, make_request, weights):
    """The family trace on ``engine`` (made with ``FAMILY_RANKS``, max
    batch 4), every adapter's nonzero ``weights`` installed first.
    Returns {id: tokens}."""
    for aid, r in sorted(engine.adapter_ranks.items()):
        engine.install_adapter(aid, r, weights[aid])
    for req in family_trace(make_request):
        engine.submit(req)
    engine.run_until_drained()
    return {r.req_id: list(r.output) for r in engine.completed}


class MoESpy:
    """While entered, counts the MoE layer's calls by path: ``moe_ffn``
    as the model calls it (by sequence length) and ``moe_ffn_ep``."""

    def __init__(self):
        from repro_torch.models import ffn
        from repro_torch.models import model as M
        self.ffn, self.M = ffn, M
        self.calls = {"ep": 0, "prefill": 0, "decode": 0}

    def __enter__(self):
        self.orig = (self.M.moe_ffn, self.ffn.moe_ffn_ep)

        def moe_ffn(cfg, p, x, *a, **kw):
            self.calls["prefill" if x.shape[1] > 1 else "decode"] += 1
            return self.orig[0](cfg, p, x, *a, **kw)

        def moe_ffn_ep(*a, **kw):
            self.calls["ep"] += 1
            return self.orig[1](*a, **kw)
        self.M.moe_ffn, self.ffn.moe_ffn_ep = moe_ffn, moe_ffn_ep
        return self

    def __exit__(self, *exc):
        self.M.moe_ffn, self.ffn.moe_ffn_ep = self.orig


def _np(x):
    return x.detach().float().numpy().copy()


def _layer(params, path):
    """A sub-module of ``params`` by dotted path (``blocks.0.attn``)."""
    for key in path.split("."):
        params = params[int(key)] if key.isdigit() else getattr(params, key)
    return params


def _layer_outputs(cfg, lp, mesh, job):
    """One layer-level case on this rank: the outputs of the layer ``lp``
    (the rank's slice) on the job's numpy inputs, as numpy. Whole outputs
    (after an all-reduce or all-gather) and the rank's slices alike;
    the test puts the slices together."""
    from repro_torch.models import attention as A
    from repro_torch.models import ffn, ssm
    t = {k: torch.from_numpy(v) for k, v in job["inputs"].items()}
    kind, out = job["kind"], {}
    lora = None
    if job.get("bank") is not None:
        sh = EngineSharding(mesh, cfg)
        bank = sh.shard_bank(bridge.bank_from_numpy(cfg, job["bank"],
                                                    device="cpu"))
        lora = make_lora_cb(bank_layer(bank.data, 0),
                            torch.from_numpy(job["idx"]), kernel="sgmv",
                            tp=mesh, gathered=("k",) if cfg.mla else ())
    if kind == "mla":
        y, (c, kr) = A.mla_full(cfg, lp, t["x"], lora=lora, tp=mesh)
        out.update(y=y, c=c, kr=kr)
        S = c.shape[1]
        cc = torch.cat([c, torch.zeros_like(c[:, :1])], 1)
        kc = torch.cat([kr, torch.zeros_like(kr[:, :1])], 1)
        pos = torch.full((c.shape[0],), S, dtype=torch.int32)
        out["y1"], _ = A.mla_decode(cfg, lp, t["x1"], cc, kc, pos,
                                    lora=lora, tp=mesh)
    elif kind == "gqa":
        y, (k, v) = A.gqa_full(cfg, lp, t["x"], lora=lora, tp=mesh)
        out.update(y=y, k=k, v=v)
        S = k.shape[1]
        kc = torch.cat([k, torch.zeros_like(k[:, :1])], 1)
        vc = torch.cat([v, torch.zeros_like(v[:, :1])], 1)
        pos = torch.full((k.shape[0],), S, dtype=torch.int32)
        out["y1"], (kc, vc) = A.gqa_decode(cfg, lp, t["x1"], kc, vc, pos,
                                           lora=lora, tp=mesh)
        out.update(k1=kc, v1=vc)
    elif kind == "cross":
        k, v = A.cross_kv(cfg, lp, t["memory"])
        out.update(k=k, v=v, y=A.cross_attend(cfg, lp, t["x"], k, v,
                                              tp=mesh),
                   y1=A.cross_attend(cfg, lp, t["x1"], k, v, tp=mesh))
    elif kind == "mamba2":
        st = ssm.mamba2_state(cfg, t["x"].shape[0], tp=mesh)
        y, s = ssm.mamba2_full(cfg, lp, t["x"], st, tp=mesh)
        y1, s1 = ssm.mamba2_step(cfg, lp, t["x1"], s, tp=mesh)
        out.update(y=y, s=s, y1=y1, s1=s1)
    elif kind == "rwkv6":
        st = ssm.rwkv6_state(cfg, t["x"].shape[0], tp=mesh)
        y, s = ssm.rwkv6_time_mix(cfg, lp, t["x"], st, lora, tp=mesh)
        y1, s1 = ssm.rwkv6_time_mix(cfg, lp, t["x1"], s, lora, tp=mesh)
        yc, _ = ssm.rwkv6_channel_mix(cfg, lp, t["x"], st, tp=mesh)
        out.update(y=y, wkv=s["wkv"], x_tm=s["x_tm"], y1=y1,
                   wkv1=s1["wkv"], yc=yc)
    elif kind == "moe":
        y, _ = ffn.moe_ffn(cfg, lp, t["x"], tp=mesh)
        out["y"] = y
        out["ep"] = ffn.ep_applicable(cfg, t["x"].shape[1], mesh)
    return {k: v if isinstance(v, bool) else _np(v) for k, v in out.items()}


def family_job(rank: int, tp: int, job_path, out_dir) -> None:
    """One rank of ``test_torch_tp_families.py``. The job pickle holds
    ``archs``: {arch: {"params" (the JAX param tree as numpy), "weights"
    ({adapter: {target: {"A", "B"}}} numpy), "model" (inputs of a
    model-level prefill and decode: ``tokens``, ``frontend`` or None,
    ``bank`` fields, ``idx``, ``steps``)}} and ``layers``: [{"arch",
    "path", "kind", "inputs", "bank", "idx"}]. Writes
    ``out_dir/family{rank}.pkl``: ``engine`` {(arch, mode, kernel):
    tokens}, ``moe_calls`` {(arch, mode, kernel): MoESpy counts},
    ``model`` {arch: [logits of the prefill and of each decode step]},
    ``layers`` [outputs], ``gathered`` {arch: the engine's full-width
    weights of ``b-r32`` after the run}, ``evicted`` {arch: bool} and
    ``cache_heads`` {arch: {cache key: shape}}."""
    from repro_torch.models import model as M
    with open(job_path, "rb") as f:
        job = pickle.load(f)
    mesh = make_engine_mesh(1, tp, device="cpu")
    out = {"engine": {}, "moe_calls": {}, "model": {}, "layers": [],
           "gathered": {}, "evicted": {}, "cache_heads": {}}
    full = {}
    for arch, a in job["archs"].items():
        cfg = get_smoke_config(arch)
        full[arch] = bridge.params_from_numpy(cfg, a["params"], device="cpu")
        params = EngineSharding(mesh, cfg).shard_params(full[arch])
        weights = {aid: bridge.adapter_weights_from_numpy(w)
                   for aid, w in a["weights"].items()}
        for mode, kernel in FAMILY_CASES:
            eng = ServingEngine(cfg, params, dict(FAMILY_RANKS),
                                max_batch=4, max_len=24, bank_mode=mode,
                                lora_kernel=kernel, mesh=mesh, device="cpu")
            with MoESpy() as spy:
                out["engine"][(arch, mode, kernel)] = serve_family(
                    eng, lambda *r: Request(*r, arrival=0.0), weights)
            out["moe_calls"][(arch, mode, kernel)] = dict(spy.calls)
        out["gathered"][arch] = {
            t: {k: v.numpy() for k, v in w.items()}
            for t, w in eng.adapter_weights("b-r32").items()}
        out["evicted"][arch] = eng.evict_adapter("c-r16") and \
            "c-r16" not in eng.adapter_ranks
        out["cache_heads"][arch] = {k: tuple(v.shape)
                                    for k, v in eng.cache.items()}
        m = a["model"]
        bank = EngineSharding(mesh, cfg).shard_bank(
            bridge.bank_from_numpy(cfg, m["bank"], device="cpu"))
        idx = torch.from_numpy(m["idx"])
        fe = None if m["frontend"] is None else torch.from_numpy(
            m["frontend"])
        lg, cache = M.prefill(cfg, params, torch.from_numpy(m["tokens"]),
                              frontend=fe, bank=bank.data, lora_idx=idx,
                              cache_len=m["tokens"].shape[1] + len(
                                  m["steps"]),
                              lora_kernel="sgmv", tp=mesh)
        logits = [_np(lg)]
        for tok in m["steps"]:
            lg, cache = M.decode_step(cfg, params, cache,
                                      torch.from_numpy(tok), bank=bank.data,
                                      lora_idx=idx, lora_kernel="sgmv",
                                      tp=mesh)
            logits.append(_np(lg))
        out["model"][arch] = logits
    for lj in job["layers"]:
        cfg = get_smoke_config(lj["arch"])
        lp = EngineSharding(mesh, cfg).shard_module(
            _layer(full[lj["arch"]], lj["path"]))
        out["layers"].append(_layer_outputs(cfg, lp, mesh, lj))
    with open(Path(out_dir) / f"family{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
