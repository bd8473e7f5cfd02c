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
from repro_torch.lora.batched import LayoutPlan, make_lora_cb
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


def _rank_delta(mesh, sharding, cfg, d, planned=False):
    """This rank's column slice of each target's co-sharded delta at
    layer 0: q gets the full-width x, o the rank's heads of its x. With
    ``planned`` the hook takes the index tensor in a ``LayoutPlan``:
    (the deltas, the layouts the plan built)."""
    bank = sharding.shard_bank(bridge.bank_from_numpy(cfg, d["bank"],
                                                      device="cpu"))
    idx, built = torch.from_numpy(d["idx"]), []
    if planned:
        idx = LayoutPlan(idx, lambda: built.append(1))
    cb = make_lora_cb(bank_layer(bank.data, 0), idx, kernel=d["kernel"],
                      tp=mesh)
    out = {}
    for name, x in d["x"].items():
        x = torch.from_numpy(x)
        if name == "o":
            w = x.shape[-1] // mesh.size
            x = x[..., mesh.rank * w:(mesh.rank + 1) * w]
        out[name] = cb(name, x).numpy()
    return (out, len(built)) if planned else out


def rank_job(rank: int, tp: int, job_path, out_dir) -> None:
    """One rank of a CPU parity run. The job pickle holds ``model`` (a
    smoke config name), ``params`` (the JAX param tree as numpy),
    ``weights`` ({adapter: {target: {"A", "B"}}} numpy), ``cases``
    [(bank_mode, lora_kernel, decode_block)] and ``deltas`` [{"mode",
    "kernel", "bank" (JAX ``LoRABank`` fields as numpy), "idx" (its
    ``lora_idx``), "x" {target: (Bt, S, d_in)}}]. Writes
    ``out_dir/rank{rank}.pkl``: ``shards`` (this rank's sliced params),
    ``delta`` {(mode, kernel, target): column slice}, ``plan_delta`` the
    same with the index tensor in a ``LayoutPlan`` and ``plan_builds``
    {(mode, kernel): layouts it built}, ``engine`` {case: lifecycle
    tokens} and ``adapter_weights`` (``a-r8`` as the last engine gives it
    to a peer, full width)."""
    with open(job_path, "rb") as f:
        job = pickle.load(f)
    cfg = get_smoke_config(job["model"])
    mesh = make_engine_mesh(1, tp, device="cpu")
    sharding = EngineSharding(mesh, cfg)
    params = bridge.params_from_numpy(cfg, job["params"], device="cpu")
    out = {"shards": {n: p.detach().numpy().copy() for n, p in
                      sharding.shard_params(params).named_parameters()},
           "delta": {}, "plan_delta": {}, "plan_builds": {}, "engine": {}}
    for d in job["deltas"]:
        form = (d["mode"], d["kernel"])
        for name, y in _rank_delta(mesh, sharding, cfg, d).items():
            out["delta"][(*form, name)] = y
        planned, out["plan_builds"][form] = _rank_delta(
            mesh, sharding, cfg, d, planned=True)
        for name, y in planned.items():
            out["plan_delta"][(*form, name)] = y
    weights = {aid: bridge.adapter_weights_from_numpy(w, device="cpu")
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
        st = ssm.mamba2_state(cfg, t["x"].shape[0], device="cpu",
                               tp=mesh)
        y, s = ssm.mamba2_full(cfg, lp, t["x"], st, tp=mesh)
        y1, s1 = ssm.mamba2_step(cfg, lp, t["x1"], s, tp=mesh)
        out.update(y=y, s=s, y1=y1, s1=s1)
    elif kind == "rwkv6":
        st = ssm.rwkv6_state(cfg, t["x"].shape[0], device="cpu",
                              tp=mesh)
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
        weights = {aid: bridge.adapter_weights_from_numpy(w, device="cpu")
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


# ---------------------------------------------------------------------------
# data parallelism (``test_torch_dp.py``)
# ---------------------------------------------------------------------------
# (bank_mode, lora_kernel, decode_block, max_batch): 4 splits the slot
# batch over dp = 2, 3 leaves it whole on every replica
DP_CASES = [(mode, kernel, k, mb) for mode in ("padded", "bucketed")
            for kernel in ("einsum", "sgmv") for k in (1, 4) for mb in (4, 3)]


def serve_drops(engine, make_request, weights):
    """The MoE capacity trace on ``engine`` (``FAMILY_RANKS``, max batch
    4, every adapter's ``weights`` installed first): a group of 2
    identical requests (16 copies of one token, one adapter), served until
    drained, then a group of 3 of 12. Identical rows of one repeated token
    route every position of a layer to the same top-k experts, so the
    expert-parallel path's capacity decides which are dropped: at (dp,
    tp) = (2, 2) dp splits the first group (8 tokens a shard, capacity 8:
    none dropped; unsplit, 16 at capacity 12 drop 4) and not the second
    (18 tokens a shard at capacity 14). Returns {id: tokens}."""
    for aid, r in sorted(engine.adapter_ranks.items()):
        engine.install_adapter(aid, r, weights[aid])
    aids = sorted(FAMILY_RANKS)
    for i in range(2):
        engine.submit(make_request(i, aids[0], [7] * 16, 4))
    engine.run_until_drained()
    for i in range(3):
        engine.submit(make_request(2 + i, aids[1], [11] * 12, 4))
    engine.run_until_drained()
    return {r.req_id: list(r.output) for r in engine.completed}


DP_TRACES = {"lifecycle": lifecycle, "family": serve_family,
             "drops": serve_drops}


class EPBatches:
    """While entered, counts ``moe_ffn_ep``'s calls by the rows they get
    (a dp split shows as a call of B rows and one of B / dp inside it)
    and the assignments its chunks' capacity drops, by those rows."""

    def __init__(self):
        from repro_torch.models import ffn
        self.ffn, self.rows, self.drops = ffn, {}, {}

    def __enter__(self):
        self.orig = (self.ffn.moe_ffn_ep, self.ffn._ep_chunk)

        def moe_ffn_ep(cfg, p, x, tp):
            self.rows[x.shape[0]] = self.rows.get(x.shape[0], 0) + 1
            return self.orig[0](cfg, p, x, tp)

        def _ep_chunk(cfg, router, x, j, n):
            out = self.orig[1](cfg, router, x, j, n)
            dest, C = out[3], out[4]
            dropped = int((dest >= cfg.moe.n_experts * C).sum())
            self.drops[x.shape[0]] = self.drops.get(x.shape[0], 0) + dropped
            return out
        self.ffn.moe_ffn_ep, self.ffn._ep_chunk = moe_ffn_ep, _ep_chunk
        return self

    def __exit__(self, *exc):
        self.ffn.moe_ffn_ep, self.ffn._ep_chunk = self.orig


def _vocab_case(cfg, mesh, seed=3):
    """The vocab-parallel head against the replicated one on ``mesh``:
    the rank's slice of a seeded model (``shard_params``), the same slice
    with the whole ``embed`` and ``lm_head`` (replicated), and the slice
    drawn directly (``init_params(tp=...)``). Returns the embedding's
    rows, the head's columns (None if tied), whether the drawn slice is
    the cut one, and the prefill's and 2 decode steps' logits of the
    split and the replicated model."""
    from repro_torch.models import model as M
    full = M.init_params(cfg, seed, device="cpu")
    sh = EngineSharding(mesh, cfg)
    split = sh.shard_params(full)
    repl = sh.shard_params(full)
    repl.embed = full.embed
    if not cfg.tie_embeddings:
        repl.lm_head = full.lm_head
    drawn = M.init_params(cfg, seed, device="cpu", tp=mesh)
    same = all(torch.equal(a, b) for a, b in
               zip(split.parameters(), drawn.parameters()))
    g = torch.Generator().manual_seed(seed)
    V = cfg.vocab_size
    toks = torch.randint(0, V, (3, 8), generator=g)
    toks[0, :2] = torch.tensor([0, V - 1])       # the first and last rows
    steps = [torch.randint(0, V, (3,), generator=g) for _ in range(2)]
    logits = {}
    for name, params in (("split", split), ("repl", repl)):
        lg, cache = M.prefill(cfg, params, toks, cache_len=10, tp=mesh)
        seq = [_np(lg)]
        for tok in steps:
            lg, cache = M.decode_step(cfg, params, cache, tok, tp=mesh)
            seq.append(_np(lg))
        logits[name] = seq
    head = None if cfg.tie_embeddings else tuple(split.lm_head.shape)
    return {"embed": tuple(split.embed.shape), "lm_head": head,
            "drawn_is_cut": same, **logits}


def dp_job(rank: int, dp: int, tp: int, job_path, out_dir) -> None:
    """One rank of ``test_torch_dp.py``'s (dp, tp) world. The job pickle
    holds ``archs``: {arch: {"params" (the JAX param tree as numpy),
    "weights" ({adapter: {target: {"A", "B"}}} numpy), "ranks" (the
    engine's adapters), "trace" (a ``DP_TRACES`` key), "max_len",
    "cases" [``DP_CASES`` entries]}} and ``vocab``: [(name, config
    overrides)] checked at tp = the world's size. Writes
    ``out_dir/dp{rank}.pkl``: ``coords`` (dp rank, tp rank), ``tp_sum``
    (a tp all-reduce of ones), ``dp_gather`` (the dp group's global
    ranks, gathered), ``engine`` {(arch, *case): tokens}, ``cache_rows``
    {(arch, *case): the cache's slot rows}, ``ep_rows`` and ``ep_drops``
    {(arch, *case): ``EPBatches.rows`` and ``.drops``} and ``vocab``
    {name: ``_vocab_case``}."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.models.common import all_gather_, all_reduce_
    with open(job_path, "rb") as f:
        job = pickle.load(f)
    mesh = make_engine_mesh(dp, tp, device="cpu")
    out = {"coords": (mesh.dp.rank, mesh.rank),
           "tp_sum": float(all_reduce_(torch.ones(1), mesh)),
           "dp_gather": all_gather_(torch.tensor([float(dist.get_rank())]),
                                    mesh.dp).tolist(),
           "engine": {}, "cache_rows": {}, "ep_rows": {}, "ep_drops": {},
           "vocab": {}}
    for arch, a in job["archs"].items():
        cfg = get_smoke_config(arch)
        params = bridge.params_from_numpy(cfg, a["params"], device="cpu")
        weights = {aid: bridge.adapter_weights_from_numpy(w, device="cpu")
                   for aid, w in a["weights"].items()}
        for case in a["cases"]:
            mode, kernel, k, mb = case
            eng = ServingEngine(cfg, params, dict(a["ranks"]), max_batch=mb,
                                max_len=a["max_len"], bank_mode=mode,
                                lora_kernel=kernel, decode_block=k,
                                mesh=mesh, device="cpu")
            with EPBatches() as spy:
                out["engine"][(arch, *case)] = DP_TRACES[a["trace"]](
                    eng, lambda *r: Request(*r, arrival=0.0), weights)
            out["cache_rows"][(arch, *case)] = eng.cache["pos"].shape[0]
            out["ep_rows"][(arch, *case)] = spy.rows
            out["ep_drops"][(arch, *case)] = spy.drops
    vmesh = make_engine_mesh(1, dp * tp, device="cpu")
    base = get_smoke_config("llama-7b-paper")
    for name, over in job["vocab"]:
        out["vocab"][name] = _vocab_case(dataclasses.replace(base, **over),
                                         vmesh)
    with open(Path(out_dir) / f"dp{rank}.pkl", "wb") as f:
        pickle.dump(out, f)


# ---------------------------------------------------------------------------
# the cluster facade over a mesh (``test_torch_mesh_cluster.py``)
# ---------------------------------------------------------------------------
def port_facade(backend, scenario):
    """The port's ``LoRAServeCluster`` over ``backend`` for a scenario
    dict (``adapters``, ``policy`` settings, ``kill``): the facade of
    ``test_torch_cluster.py``'s port side."""
    from repro_torch.cluster import NetworkModel
    from repro_torch.faults import FaultPlan
    from repro_torch.serving import LoRAServeCluster
    kw = dict(policy="loraserve", rebalance_period=scenario["rebalance"],
              seed=scenario["seed"], access_mode=scenario["access_mode"])
    kill = scenario.get("kill")
    if kill is not None:
        kw.update(detector_window=0.3, durable_ssd=True,
                  fault_plan=FaultPlan.kill_one(*kill))
    return LoRAServeCluster(backend, scenario["adapters"],
                            network=NetworkModel(), **kw)


def scenario_backend(cfg, params, weights, scenario, mesh_shape=None):
    """The seeded engine backend of a scenario: 2 servers, fp32, padded
    (``launch.serve.SeededWeightsBackend``), on ``mesh_shape``."""
    from repro_torch.launch.serve import SeededWeightsBackend
    return SeededWeightsBackend(
        cfg, params, 2, weights=weights, max_batch=scenario["max_batch"],
        max_len=scenario["max_len"], seed=0, mesh_shape=mesh_shape,
        device="cpu")


def cluster_outcome(cluster, report, trace):
    """What the mesh cluster test compares: routes, per-server counts,
    tokens and the report's counters."""
    return {"routed": list(cluster.routed),
            "counts": list(report.per_server_counts),
            "tokens": {r.req_id: list(r.output) for r in trace},
            "completed": report.completed(),
            "rebalances": report.rebalances,
            "placements": report.placements,
            "remote_reads": report.remote_reads,
            "failures": report.server_failures,
            "recoveries": report.recoveries,
            "mesh_shape": report.mesh_shape,
            "memory_profile": report.memory_profile}


def mesh_cluster_job(rank: int, dp: int, tp: int, job_path, out_dir) -> None:
    """One rank of a (dp, tp) world of ``test_torch_mesh_cluster.py``: the
    job pickle holds ``params`` (the JAX param tree as numpy),
    ``weights`` and ``scenarios`` [{"adapters", "trace", "dt", ...}].
    For each scenario every rank builds the mesh's backend; rank 0 drives
    the facade on the virtual clock (``launch.serve.drive``) and closes
    the backend, the others follow it (``serve_follower``). Rank 0 writes
    ``out_dir/cluster-{dp}x{tp}.pkl``: [``cluster_outcome``]."""
    from repro_torch.launch.serve import drive
    from repro_torch.serving.backend import serve_follower
    with open(job_path, "rb") as f:
        job = pickle.load(f)
    cfg = get_smoke_config("llama-7b-paper")
    params = bridge.params_from_numpy(cfg, job["params"], device="cpu")
    weights = {aid: bridge.adapter_weights_from_numpy(w, device="cpu")
               for aid, w in job["weights"].items()}
    outs = []
    for sc in job["scenarios"]:
        backend = scenario_backend(cfg, params, weights, sc, (dp, tp))
        if rank != 0:
            serve_follower(backend)
            continue
        cluster = port_facade(backend, sc)
        trace = sc["trace"]
        report = drive(cluster, trace, sc["dt"])
        backend.close()
        outs.append(cluster_outcome(cluster, report, trace))
    if rank == 0:
        with open(Path(out_dir) / f"cluster-{dp}x{tp}.pkl", "wb") as f:
            pickle.dump(outs, f)
