"""PyTorch port, tensor parallelism for every family: gloo ranks spawned
on the CPU at tp = 2 and 4 (one world each, a module fixture, running
``_torch_tp_rank.family_job``), on the smoke configs of the MoE family
(deepseek-v2-lite-16b: MLA, 4 experts top-2 and a shared one;
llama4-scout: GQA 4/2, 4 experts top-1), the hybrid (zamba2), RWKV-6, the
encoder-decoder (seamless, a nonzero frontend at model level), the VLM
(llama-3.2-vision, nonzero gates and frontend) and four dense ones
(qwen2.5-32b GQA 8/2 with q/k/v biases, codeqwen1.5-7b, internlm2-1.8b
GQA 4/2, stablelm-1.6b: ROADMAP R2). Weights are the JAX package's,
bridged through numpy; adapter banks hold nonzero B.

* layer level: every rank's outputs and its slices of the caches put
  back together (``EngineSharding.join``) equal the JAX single-device
  layer's, fp32 1e-5 (1e-4 where an all-reduce reorders a long sum, or a
  recurrence carries it): MLA with the ``k`` adapter gathered, GQA
  through the kv-head regroup (Kv 2 at tp 4), cross-attention (VLM and
  seamless), Mamba2, RWKV-6 (time and channel mix) and the MoE's
  drop-free path; the expert-parallel path equals ``moe_ffn_ep_ref``;
* ``moe_ffn_ep_ref`` against the reference's own pieces, on one JAX
  device: ``_route_pack(..., 1.5, exact_small=False)`` and ``_combine``
  per sequence chunk, ``keep``/``dest`` equal exactly and outputs within
  1e-5, in a case that drops tokens;
* model level: each rank's prefill and decode logits (LoRA on the SGMV
  path's plain versions) equal the JAX model's (1e-4); for the MoE
  family the reference is the port at tp = 1 with ``moe_ffn_ep_ref`` at
  prefill (the JAX mesh's numbers, not one device's);
* engine level: every rank's tokens, in both bank modes and both LoRA
  forms, equal the JAX engine's on the same trace: the JAX mesh engine
  (``make_engine_mesh(1, tp)``, 8 host devices, run once in one
  subprocess beside the worlds, as ``test_mesh_sharding.PARITY_SCRIPT``
  runs it) where its numbers differ from one device's (MoE: expert
  parallelism at prefill; Kv 2 at tp 4: the regroup), its single-device
  engine elsewhere. The MoE prefill runs the expert-parallel path and
  the decode the drop-free one (a spy counts them). Each rank gives a
  peer full-width adapter weights and evicts an adapter;
* the layout: ``EngineSharding`` builds a rank's layout for every config
  (tp = 2 for every smoke config, reassembled exactly; tp = 2 and 4 for
  every full-width one) and refuses what tp does not divide.
"""
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_tp_rank as tp_rank
from _torch_jax_side import nonzero_weights
from repro.configs import get_smoke_config
from repro.lora.bank import LoRABank as JaxLoRABank
from repro.lora.batched import make_lora_cb as jax_make_lora_cb
from repro.models import attention as JA
from repro.models import ffn as JF
from repro.models import model as JM
from repro.models import ssm as JS
from repro_torch import bridge
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.launch.mesh import TensorParallel, spawn
from repro_torch.models import attention as TA
from repro_torch.models import ffn as TF
from repro_torch.models import model as TM
from repro_torch.serving.sharding import EngineSharding

DEEPSEEK, LLAMA4 = "deepseek-v2-lite-16b", "llama4-scout-17b-a16e"
ZAMBA, RWKV = "zamba2-7b", "rwkv6-7b"
SEAMLESS, VISION = "seamless-m4t-large-v2", "llama-3.2-vision-90b"
R2 = ["qwen2.5-32b", "codeqwen1.5-7b", "internlm2-1.8b", "stablelm-1.6b"]
ARCHS = [DEEPSEEK, LLAMA4, ZAMBA, RWKV, SEAMLESS, VISION] + R2
MOE = (DEEPSEEK, LLAMA4)
TPS = (2, 4)
ALL_RANKS = tp_rank.FAMILY_RANKS
SRC = os.path.join(os.path.dirname(__file__), os.pardir, "src")
HERE = os.path.dirname(__file__)


def _regrouped(arch, tp):
    cfg = get_smoke_config(arch)
    return cfg.n_kv_heads % tp != 0


def _mesh_ref(arch, tp):
    """Where the JAX mesh engine is the reference: its numbers differ from
    one device's (expert parallelism; the regroup, whose numbers are the
    same in exact arithmetic but not its sums)."""
    return arch in MOE or _regrouped(arch, tp)


# -- the JAX side ---------------------------------------------------------

def _nested(named):
    """{dotted name: array} -> the nested dict of a JAX param tree."""
    tree = {}
    for name, a in named.items():
        *keys, leaf = name.split(".")
        node = tree
        for key in keys:
            node = node.setdefault(key, {})
        node[leaf] = a
    return tree


def _params_tree(arch, seed):
    """A param tree in the JAX package's layout (``models/model.py:
    init_params``: stacked layers), as numpy: the port's seeded weights
    (drawn faster than JAX's on this host; ``bridge.params_from_numpy``
    is their inverse), with random norms, biases and per-head vectors so
    that every split of them shows, and the VLM's gates nonzero (0 at
    init: the identity)."""
    cfg = get_smoke_config(arch)
    lm = TM.init_params(t_smoke(arch), seed, device="cpu")
    rng = np.random.default_rng(seed)

    def leaf(name, p):
        a = p.detach().numpy().copy()
        if name.rsplit(".", 1)[-1] in _VECTORS:
            a = a + rng.standard_normal(a.shape).astype(np.float32) * 0.2
        return a
    tree = {n: leaf(n, p) for n, p in lm.named_parameters(recurse=False)}
    for name, child in lm.named_children():
        if isinstance(child, torch.nn.ModuleList):
            per = [{n: leaf(n, p) for n, p in b.named_parameters()}
                   for b in child]
            tree[name] = _nested({n: np.stack([d[n] for d in per])
                                  for n in per[0]})
        else:
            tree[name] = _nested({n: leaf(n, p)
                                  for n, p in child.named_parameters()})
    if cfg.family == "vlm":
        n = cfg.n_layers // cfg.cross_attn_every
        cb = tree["cross_blocks"]
        cb["gate_attn"] = np.linspace(0.5, 0.9, n, dtype=np.float32
                                      ).reshape(n, 1)
        cb["gate_ffn"] = np.linspace(-0.4, -0.8, n, dtype=np.float32
                                     ).reshape(n, 1)
    return tree


# norms, biases and per-head vectors: made random, so that a split of
# them that went wrong shows
_VECTORS = {"bq", "bk", "bv", "dt_bias", "A_log", "D", "ln_y", "w0", "u",
            "ln_x", "ln_kv", "ln1", "ln2", "lnc", "ln"}


def _bank(cfg, weights):
    """A padded bank of the nonzero ``weights`` (every adapter padded to
    the largest rank with zeros, adapters sorted: the layout of both
    packages' ``build_bank``): (the JAX ``LoRABank``, its numpy fields)."""
    ids = sorted(ALL_RANKS)
    ranks = [ALL_RANKS[a] for a in ids]
    R = max(ranks)
    data = {}
    for t in cfg.lora.targets:
        L, d_in, _ = weights[ids[0]][t]["A"].shape
        d_out = weights[ids[0]][t]["B"].shape[-1]
        A = np.zeros((L, len(ids), d_in, R), np.float32)
        B = np.zeros((L, len(ids), R, d_out), np.float32)
        for i, (aid, r) in enumerate(zip(ids, ranks)):
            A[:, i, :, :r] = weights[aid][t]["A"]
            B[:, i, :r] = weights[aid][t]["B"]
        data[t] = {"A": A, "B": B}
    fields = dict(mode="padded", adapter_ids=tuple(ids), ranks=tuple(ranks),
                  data=data, bucket_ranks=(), bucket_counts=(),
                  adapter_bucket=None, adapter_local=None)
    jb = JaxLoRABank("padded", tuple(ids), tuple(ranks),
                     jax.tree.map(jnp.asarray, data))
    return jb, fields


def _frontend(cfg, B, seed=11):
    if not JM.n_cross_applications(cfg):
        return None
    M = cfg.encoder.n_frames if cfg.encoder else cfg.n_frontend_tokens
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, M, cfg.d_model)) * 0.5).astype(
        np.float32)


def _jax_layer(jp, path):
    parts = path.split(".")
    tree = jp[parts[0]]
    rest = parts[1:]
    if rest and rest[0].isdigit():
        tree = jax.tree.map(lambda a, i=int(rest[0]): a[i], tree)
        rest = rest[1:]
    for key in rest:
        tree = tree[key]
    return tree


# (case id, arch, layer path, kind, {input: shape}, with a LoRA bank)
LAYERS = [
    ("mla", DEEPSEEK, "blocks.0.attn", "mla", {"x": (3, 8), "x1": (3, 1)},
     True),
    ("gqa-regroup", LLAMA4, "blocks.0.attn", "gqa",
     {"x": (3, 8), "x1": (3, 1)}, True),
    ("gqa-bias-regroup", R2[0], "blocks.0.attn", "gqa",
     {"x": (3, 8), "x1": (3, 1)}, True),
    ("cross-vlm", VISION, "cross_blocks.0.attn", "cross",
     {"memory": (3, 16), "x": (3, 8), "x1": (3, 1)}, False),
    ("cross-seamless", SEAMLESS, "dec_blocks.0.cross", "cross",
     {"memory": (3, 16), "x": (3, 8), "x1": (3, 1)}, False),
    ("mamba2", ZAMBA, "mamba_blocks.0", "mamba2",
     {"x": (3, 8), "x1": (3, 1)}, False),
    ("rwkv6", RWKV, "blocks.0", "rwkv6", {"x": (3, 8), "x1": (3, 1)}, True),
    ("moe-scatter-deepseek", DEEPSEEK, "blocks.0.ffn", "moe",
     {"x": (5, 1)}, False),
    ("moe-scatter-llama4", LLAMA4, "blocks.0.ffn", "moe", {"x": (2, 3)},
     False),
    ("moe-ep-deepseek", DEEPSEEK, "blocks.0.ffn", "moe", {"x": (3, 8)},
     False),
    ("moe-ep-llama4", LLAMA4, "blocks.0.ffn", "moe", {"x": (2, 16)},
     False),
]
IDX = np.array([0, 2, 1], np.int32)


def _layer_inputs(cfg, shapes, seed):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s + (cfg.d_model,)) * 0.5).astype(
        np.float32) for k, s in shapes.items()}


def _jax_layer_outputs(cfg, p, kind, x, jb):
    """The JAX single-device layer on the same inputs (the rank's outputs'
    names), LoRA from layer 0 of ``jb`` when given; one jitted call."""
    bank = None if jb is None else jax.tree.map(lambda a: a[0], jb.data)
    idx = None if jb is None else jnp.asarray(IDX)
    f = jax.jit(lambda p, x, bank, idx: _jax_layer_fn(cfg, p, kind, x,
                                                       bank, idx))
    return {k: np.asarray(v) for k, v in f(p, x, bank, idx).items()}


def _jax_layer_fn(cfg, p, kind, x, bank, idx):
    cb = None if bank is None else jax_make_lora_cb(bank, idx,
                                                    kernel="einsum")
    j = {k: jnp.asarray(v) for k, v in x.items()}
    out = {}
    if kind in ("mla", "gqa"):
        S = j["x"].shape[1]
        B = j["x"].shape[0]
        pos = jnp.full((B,), S, jnp.int32)
        full, dec = (JA.mla_full, JA.mla_decode) if kind == "mla" else \
            (JA.gqa_full, JA.gqa_decode)
        y, (a, b) = full(cfg, p, j["x"], jnp.arange(S), lora=cb)
        pad = [(0, 0), (0, 1)] + [(0, 0)] * (a.ndim - 2)
        y1, (a1, b1) = dec(cfg, p, j["x1"], jnp.pad(a, pad),
                           jnp.pad(b, pad), pos, lora=cb)
        names = ("c", "kr") if kind == "mla" else ("k", "v")
        out.update(y=y, y1=y1, **dict(zip(names, (a, b))))
        if kind == "gqa":
            out.update(k1=a1, v1=b1)
    elif kind == "cross":
        k, v = JA.cross_kv(cfg, p, j["memory"])
        out.update(k=k, v=v, y=JA.cross_attend(cfg, p, j["x"], k, v),
                   y1=JA.cross_attend(cfg, p, j["x1"], k, v))
    elif kind == "mamba2":
        st = JS.mamba2_state(cfg, j["x"].shape[0])
        y, s = JS.mamba2_full(cfg, p, j["x"], st)
        y1, s1 = JS.mamba2_step(cfg, p, j["x1"], s)
        out.update(y=y, s=s, y1=y1, s1=s1)
    elif kind == "rwkv6":
        st = JS.rwkv6_state(cfg, j["x"].shape[0])
        y, s = JS.rwkv6_time_mix(cfg, p, j["x"], st, cb)
        y1, s1 = JS.rwkv6_time_mix(cfg, p, j["x1"], {**st, **s}, cb)
        yc, _ = JS.rwkv6_channel_mix(cfg, p, j["x"], st)
        out.update(y=y, wkv=s["wkv"], x_tm=s["x_tm"], y1=y1,
                   wkv1=s1["wkv"], yc=yc)
    elif kind == "moe":
        out["y"], _ = JF.moe_ffn(cfg, p, j["x"])
    return out


# the JAX engines and the JAX models' logits, in two subprocesses with 8
# host devices each, beside the ranks
REF_SCRIPT = r"""
import pickle
import sys

import jax

assert len(jax.devices()) == 8, jax.devices()

import test_torch_tp_families as T

with open(sys.argv[1], "rb") as f:
    job = pickle.load(f)
out = T._references(job, job["runs"][int(sys.argv[3])])
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
print("REF_OK")
"""


N_REF_PROCS = 3


def _ref_runs():
    """The reference runs, dealt to ``N_REF_PROCS`` subprocesses by their
    rough cost (compiles, mostly): ("mesh", arch, tp) the JAX mesh engine
    where it is the reference; ("engine", arch, 1) the single-device
    engine elsewhere, and ("model", arch, 1) the JAX model's logits (not
    the MoE family's: its reference is the port's ``moe_ffn_ep_ref``)."""
    runs = []
    for arch in ARCHS:
        runs += [("mesh", arch, tp) for tp in TPS if _mesh_ref(arch, tp)]
        if not all(_mesh_ref(arch, tp) for tp in TPS):
            runs.append(("engine", arch, 1))
        if arch not in MOE:
            runs.append(("model", arch, 1))
    cost = {"mesh": 10, "engine": 5, "model": 1.5}
    lists, load = [[] for _ in range(N_REF_PROCS)], [0.0] * N_REF_PROCS
    for run in sorted(runs, key=lambda r: -cost[r[0]]):
        i = load.index(min(load))
        lists[i].append(run)
        load[i] += cost[run[0]]
    return lists


def _references(job, runs):
    """The reference runs of one subprocess: {(kind, arch, tp): tokens
    or logits}. A JAX engine that raises is kept as its error (a
    reference fault; the test reports it)."""
    import time
    from repro.launch.mesh import make_engine_mesh
    from repro.serving import Request as JRequest
    from repro.serving import ServingEngine as JEngine
    out = {}
    for kind, arch, tp in runs:
        cfg = get_smoke_config(arch)
        a = job["archs"][arch]
        params = jax.tree.map(jnp.asarray, a["params"])
        if kind == "model":
            jb, _ = _bank(cfg, a["weights"])
            out[(kind, arch, tp)] = _jax_logits(cfg, params, jb, a["model"])
            continue
        weights = {aid: jax.tree.map(jnp.asarray, w)
                   for aid, w in a["weights"].items()}
        eng = JEngine(cfg, params, dict(ALL_RANKS), max_batch=4, max_len=24,
                      bank_mode="padded", lora_kernel="einsum",
                      mesh=None if tp == 1 else make_engine_mesh(1, tp))
        try:
            out[(kind, arch, tp)] = tp_rank.serve_family(
                eng, lambda *r: JRequest(*r, arrival=time.monotonic()),
                weights)
        except Exception as e:
            out[(kind, arch, tp)] = repr(e)
    return out


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The numpy job of every rank, the JAX layers' outputs, and the JAX
    engines' subprocess, started here so that it runs beside the ranks."""
    tmp = tmp_path_factory.mktemp("families")
    archs, jax_side = {}, {}
    for i, arch in enumerate(ARCHS):
        cfg = get_smoke_config(arch)
        tree = _params_tree(arch, i)
        jp = jax.tree.map(jnp.asarray, tree)
        weights = nonzero_weights(cfg, ALL_RANKS, 20 + i)
        jb, fields = _bank(cfg, weights)
        rng = np.random.default_rng(30 + i)
        toks = rng.integers(1, cfg.vocab_size, (3, 8)).astype(np.int32)
        steps = [rng.integers(1, cfg.vocab_size, (3,)).astype(np.int32)
                 for _ in range(2)]
        archs[arch] = {"params": tree, "weights": weights,
                       "model": {"tokens": toks, "frontend": _frontend(cfg, 3),
                                 "bank": fields, "idx": IDX,
                                 "steps": steps}}
        jax_side[arch] = (cfg, jp, jb)
    layers, want = [], []
    with open(tmp / "ref_job.pkl", "wb") as f:
        pickle.dump({"archs": archs, "runs": _ref_runs()}, f)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        [SRC, HERE, env.get("PYTHONPATH", "")])
    procs = [subprocess.Popen(
        [sys.executable, "-c", REF_SCRIPT, str(tmp / "ref_job.pkl"),
         str(tmp / f"ref_out{i}.pkl"), str(i)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env)
        for i in range(N_REF_PROCS)]
    for n, (_, arch, path, kind, shapes, with_bank) in enumerate(LAYERS):
        cfg, jp, jb = jax_side[arch]
        x = _layer_inputs(cfg, shapes, 40 + n)
        layers.append({"arch": arch, "path": path, "kind": kind,
                       "inputs": x,
                       "bank": archs[arch]["model"]["bank"] if with_bank
                       else None,
                       "idx": archs[arch]["model"]["idx"]})
        want.append(_jax_layer_outputs(cfg, _jax_layer(jp, path), kind, x,
                                       jb if with_bank else None))
    job = {"archs": archs, "layers": layers}
    with open(tmp / "job.pkl", "wb") as f:
        pickle.dump(job, f)
    yield {"tmp": tmp, "job": job, "jax": jax_side, "want": want,
           "procs": procs}
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


@pytest.fixture(scope="module")
def refs(setup):
    """{(kind, arch, tp): tokens or logits} of the reference runs."""
    out = {}
    for i, proc in enumerate(setup["procs"]):
        so, se = proc.communicate(timeout=600)
        assert proc.returncode == 0 and "REF_OK" in so, so + se
        with open(setup["tmp"] / f"ref_out{i}.pkl", "rb") as f:
            out.update(pickle.load(f))
    return out


@pytest.fixture(scope="module", params=TPS, ids=["tp2", "tp4"])
def world(request, setup):
    """Every rank's outputs of one spawned world."""
    tp = request.param
    tmp = setup["tmp"]
    spawn(tp_rank.family_job, tp, backend="gloo",
          init_file=tmp / f"init{tp}",
          args=(tp, str(tmp / "job.pkl"), str(tmp)))
    outs = []
    for r in range(tp):
        with open(tmp / f"family{r}.pkl", "rb") as f:
            outs.append(pickle.load(f))
    return tp, outs


# -- layer level ----------------------------------------------------------

def _join(cfg, tp, parts, name):
    """Rank slices (..., heads_local, hd) of k/v-like tensors put back
    together by the layout's kv-head columns."""
    lay = EngineSharding(TensorParallel(None, 0, tp), cfg)
    lead = parts[0].shape[:-2]
    flat = [torch.from_numpy(p.reshape(lead + (-1,))) for p in parts]
    full = lay.join(flat, flat[0].dim() - 1, name).numpy()
    return full.reshape(lead + (-1, parts[0].shape[-1]))


# outputs whole on every rank, and per-rank slices joined by head
_WHOLE = ("y", "y1", "yc", "c", "kr", "x_tm")
_HEADS = {"k": "wk", "v": "wv", "k1": "wk", "v1": "wv"}


@pytest.mark.parametrize("case", range(len(LAYERS)),
                         ids=[c[0] for c in LAYERS])
def test_layer_slices_match_jax(setup, world, case):
    tp, outs = world
    name, arch, _, kind, shapes, _ = LAYERS[case]
    cfg = get_smoke_config(arch)
    want = setup["want"][case]
    got = [o["layers"][case] for o in outs]
    # 1e-5 where no rank sums with another (the cross K/V), 1e-4 where an
    # all-reduce reorders a sum (every row-parallel output, the LoRA
    # shrink's) or a recurrence carries one
    tol = 1e-5 if kind == "cross" else 1e-4
    if kind == "moe" and got[0]["ep"]:
        # the expert-parallel path: against its plain reference
        tcfg = t_smoke(arch)
        p = bridge.params_from_numpy(
            tcfg, setup["job"]["archs"][arch]["params"],
            device="cpu").blocks[0].ffn
        x = torch.from_numpy(setup["job"]["layers"][case]["inputs"]["x"])
        want = {"y": TF.moe_ffn_ep_ref(tcfg, p, x, tp)[0].numpy()}
    if kind == "moe":
        assert got[0]["ep"] == name.startswith("moe-ep"), name
    for key, w in want.items():
        for r, g in enumerate(got):
            if key in _WHOLE:
                np.testing.assert_allclose(g[key], w, atol=1e-4, rtol=1e-4,
                                           err_msg=f"{name} {key} rank {r}")
        if key in _WHOLE:
            continue
        parts = [g[key] for g in got]
        if key in _HEADS:
            joined = _join(cfg, tp, parts, _HEADS[key])
        else:                        # state: the rank's heads on axis 1
            joined = np.concatenate(parts, axis=1)
        np.testing.assert_allclose(joined, w, atol=tol, rtol=tol,
                                   err_msg=f"{name} {key}")


def test_regroup_duplicates_kv_heads(world):
    """At tp 4 with Kv 2 each rank holds one kv head, a duplicate of its
    neighbour's; at tp 2 each holds its own."""
    tp, outs = world
    case = [c[0] for c in LAYERS].index("gqa-regroup")
    cfg = get_smoke_config(LLAMA4)
    n = TA.local_kv_heads(cfg, tp)
    assert n == (1 if tp == 4 else cfg.n_kv_heads // tp)
    ks = [o["layers"][case]["k"] for o in outs]
    assert all(k.shape[2] == n for k in ks)
    if tp == 4:
        np.testing.assert_array_equal(ks[0], ks[1])
        np.testing.assert_array_equal(ks[2], ks[3])
        assert not np.array_equal(ks[1], ks[2])


# -- moe_ffn_ep_ref against the reference's own pieces ---------------------

def _jax_ep(cfg, p, x, n):
    """The JAX ``moe_ffn_ep`` composed on one device from its own pieces:
    each chunk's ``_route_pack`` and ``_combine``, the experts' einsums
    on every chunk's rows in the order the ranks receive them."""
    B, S, d = x.shape
    chunks = [JF._route_pack(cfg, p["router"],
                             x[:, j * S // n:(j + 1) * S // n].reshape(-1, d),
                             1.5, exact_small=False) for j in range(n)]
    C = chunks[0][5]                       # a Python int: shapes decide it
    E = cfg.moe.n_experts
    xg = jnp.stack([c[0] for c in chunks], 1).reshape(E, n * C, d)
    h = jax.nn.silu(jnp.einsum("ecd,edf->ecf", xg, p["we1"])) * \
        jnp.einsum("ecd,edf->ecf", xg, p["we3"])
    y = jnp.einsum("ecf,efd->ecd", h, p["we2"]).reshape(E, n, C, d)
    outs = [JF._combine((B * S // n, d), y[:, j], c[1], c[2], c[3], c[4], C,
                        x.dtype).reshape(B, S // n, d)
            for j, c in enumerate(chunks)]
    out = jnp.concatenate(outs, axis=1)
    if cfg.moe.n_shared_experts:
        out = out + JF.swiglu(p, x, shared=True)
    return out, chunks


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("n", TPS)
@pytest.mark.parametrize("skew", [False, True], ids=["even", "drops"])
def test_moe_ffn_ep_ref_matches_jax_pieces(arch, n, skew):
    cfg = get_smoke_config(arch)
    tree = _params_tree(arch, 0)
    p = jax.tree.map(lambda a: jnp.asarray(a[0]), tree["blocks"]["ffn"])
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 32, cfg.d_model)).astype(np.float32)
    if skew:           # most tokens lean towards expert 0: past capacity
        r = np.asarray(p["router"])[:, 0]
        x = x * 0.3 + 4.0 * r / np.linalg.norm(r)
    want, chunks = jax.jit(lambda p, x: _jax_ep(cfg, p, x, n))(
        p, jnp.asarray(x))
    keeps = [np.asarray(c[3]) for c in chunks]
    if skew:
        assert not all(k.all() for k in keeps), "no token was dropped"
    tcfg = t_smoke(arch)
    tp = bridge.params_from_numpy(tcfg, tree, device="cpu").blocks[0].ffn
    xt = torch.from_numpy(x)
    E = cfg.moe.n_experts
    for j, c in enumerate(chunks):
        _, _, _, dest, C, _, _ = TF._ep_chunk(tcfg, tp.router, xt, j, n)
        assert C == chunks[j][5]
        np.testing.assert_array_equal(dest.numpy(), np.asarray(c[4]))
        np.testing.assert_array_equal((dest < E * C).numpy(), keeps[j])
    got, _ = TF.moe_ffn_ep_ref(tcfg, tp, xt, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


# -- model level -------------------------------------------------------------

def _port_ep_ref_logits(arch, a, tp):
    """The port at tp = 1 with ``moe_ffn_ep_ref(n=tp)`` at prefill: the
    MoE family's reference of a tp rank's numbers."""
    cfg = t_smoke(arch)
    params = bridge.params_from_numpy(cfg, a["params"], device="cpu")
    m = a["model"]
    bank = bridge.bank_from_numpy(cfg, m["bank"], device="cpu")
    idx = torch.from_numpy(m["idx"])
    orig = TM.moe_ffn

    def ep_at_prefill(cfg, p, x, **kw):
        if x.shape[1] > 1:
            return TF.moe_ffn_ep_ref(cfg, p, x, tp)
        return orig(cfg, p, x)
    TM.moe_ffn = ep_at_prefill
    try:
        lg, cache = TM.prefill(cfg, params, torch.from_numpy(m["tokens"]),
                               bank=bank.data, lora_idx=idx,
                               cache_len=8 + len(m["steps"]),
                               lora_kernel="sgmv")
        out = [lg.numpy()]
        for tok in m["steps"]:
            lg, cache = TM.decode_step(cfg, params, cache,
                                       torch.from_numpy(tok), bank=bank.data,
                                       lora_idx=idx, lora_kernel="sgmv")
            out.append(lg.numpy())
    finally:
        TM.moe_ffn = orig
    return out


def _jax_logits(cfg, jp, jb, m):
    """The JAX model's prefill and decode logits (each jitted)."""
    fe = None if m["frontend"] is None else jnp.asarray(m["frontend"])
    idx = jnp.asarray(m["idx"])
    prefill = jax.jit(lambda p, t, fe, bank: JM.prefill(
        cfg, p, t, frontend=fe, bank=bank, lora_idx=idx,
        cache_len=8 + len(m["steps"])))
    decode = jax.jit(lambda p, c, t, bank: JM.decode_step(
        cfg, p, c, t, bank=bank, lora_idx=idx))
    lg, cache = prefill(jp, jnp.asarray(m["tokens"]), fe, jb.data)
    out = [np.asarray(lg)]
    for tok in m["steps"]:
        lg, cache = decode(jp, cache, jnp.asarray(tok), jb.data)
        out.append(np.asarray(lg))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_model_logits_match_reference(setup, refs, world, arch):
    tp, outs = world
    a = setup["job"]["archs"][arch]
    if arch in MOE:
        want = _port_ep_ref_logits(arch, a, tp)
    else:
        want = refs[("model", arch, 1)]
    for r, o in enumerate(outs):
        for step, (g, w) in enumerate(zip(o["model"][arch], want)):
            np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-4,
                                       err_msg=f"{arch} rank {r} step {step}")


# -- engine level ------------------------------------------------------------

@pytest.mark.parametrize("case", tp_rank.FAMILY_CASES, ids="/".join)
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_tokens_match_jax(refs, world, arch, case):
    tp, outs = world
    want = refs[("mesh", arch, tp) if _mesh_ref(arch, tp)
                else ("engine", arch, 1)]
    assert isinstance(want, dict), f"JAX engine {arch} tp {tp}: {want}"
    assert len(want) == 6 and all(len(v) == 4 for v in want.values())
    for r, o in enumerate(outs):
        assert o["engine"][(arch, *case)] == want, (arch, case, r)


@pytest.mark.parametrize("arch", MOE)
def test_moe_prefill_runs_expert_parallel(world, arch):
    """Every MoE layer call of a prefill whose length tp divides runs the
    expert-parallel path; decode runs the drop-free one. At tp 4 the
    6-token group is not divided: its prefill takes the drop-free path
    too."""
    tp, outs = world
    L = get_smoke_config(arch).n_layers
    for o in outs:
        for case in tp_rank.FAMILY_CASES:
            c = o["moe_calls"][(arch, *case)]
            # two prefill groups (8 tokens, then 6), decode steps between
            assert c["prefill"] == 2 * L and c["decode"] > 0, c
            assert c["ep"] == (2 * L if tp == 2 else L), c


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_gathers_evicts_and_sizes_caches(setup, world, arch):
    """A rank gives a peer the adapter's full-width weights (the weights
    installed), evicts an adapter, and holds its heads' caches."""
    tp, outs = world
    cfg = get_smoke_config(arch)
    w = setup["job"]["archs"][arch]["weights"]["b-r32"]
    for o in outs:
        for t, ab in w.items():
            np.testing.assert_array_equal(o["gathered"][arch][t]["A"],
                                          ab["A"])
            np.testing.assert_array_equal(o["gathered"][arch][t]["B"],
                                          ab["B"])
        assert o["evicted"][arch]
        shapes = o["cache_heads"][arch]
        if "k" in shapes:
            assert shapes["k"][3] == TA.local_kv_heads(cfg, tp)
        if "xk" in shapes:
            assert shapes["xk"][3] == TA.local_kv_heads(cfg, tp)
        if "ssm" in shapes:
            assert shapes["ssm"][2] * tp == TM.mamba_dims(cfg)[1]
        if "wkv" in shapes:
            assert shapes["wkv"][2] * tp == cfg.d_model // cfg.ssm.head_dim
            assert shapes["x_tm"][2] == cfg.d_model
        if "c" in shapes:
            assert shapes["c"][3] == cfg.mla.kv_lora_rank


# -- the layout ----------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_layout_builds_and_reassembles(arch):
    """tp = 2: every rank's slice of the smoke model, and the slices put
    the full model back together (``bridge.check_shards``); a model drawn
    as a rank's slice (``init_params(tp=...)``) is that slice."""
    cfg = t_smoke(arch)
    full = TM.init_params(cfg, 0, device="cpu")
    shards = []
    for r in range(2):
        mesh = TensorParallel(None, r, 2)
        sh = EngineSharding(mesh, cfg)
        part = sh.shard_params(full)
        drawn = TM.init_params(cfg, 0, device="cpu", tp=mesh)
        assert sh.shard_params(drawn) is drawn
        for (n1, a), (n2, b) in zip(part.named_parameters(),
                                    drawn.named_parameters()):
            assert n1 == n2 and torch.equal(a, b), n1
        shards.append({n: p for n, p in part.named_parameters()})
    bridge.check_shards(cfg, full, shards)
    with pytest.raises(ValueError, match="back together"):
        bridge.check_shards(cfg, full, shards[::-1])


@pytest.mark.parametrize("tp", TPS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_full_width_layout_builds(arch, tp):
    """tp = 2 and 4 divide every full-width config: the layout builds on
    every rank, and its kv heads cover every head."""
    cfg = get_config(arch)
    seen = set()
    for r in range(tp):
        sh = EngineSharding(TensorParallel(None, r, tp), cfg)
        if cfg.n_heads and cfg.mla is None:
            cols = sh.index("wk", None).tolist()
            assert len(cols) == TA.local_kv_heads(cfg, tp) * \
                cfg.resolved_head_dim
            seen |= set(cols)
    if cfg.n_heads and cfg.mla is None:
        assert seen == set(range(cfg.n_kv_heads * cfg.resolved_head_dim))


def test_layout_refuses_what_tp_does_not_divide():
    import dataclasses
    cfg = t_smoke(DEEPSEEK)
    with pytest.raises(ValueError, match="n_experts=4 is not divisible"):
        EngineSharding(TensorParallel(None, 0, 8), dataclasses.replace(
            cfg, n_heads=8))
    with pytest.raises(ValueError, match="A9 slice"):
        EngineSharding(TensorParallel(None, 0, 3), t_smoke(ZAMBA))
    with pytest.raises(ValueError, match="rwkv6 heads"):
        EngineSharding(TensorParallel(None, 0, 8), t_smoke(RWKV))


def test_launcher_serves_moe_at_tp2(monkeypatch, capfd):
    """``launch/serve.py --arch deepseek-v2-lite-16b --mesh 1,2``: two
    spawned ranks, each drawing its slice (``init_params(tp=...)``)."""
    from repro_torch.launch import serve
    monkeypatch.setattr("sys.argv", [
        "serve", "--arch", DEEPSEEK, "--config", "smoke", "--device", "cpu",
        "--mesh", "1,2", "--backend", "gloo", "--requests", "3",
        "--prompt-lens", "4,6", "--max-new", "3", "--dtype", "float32"])
    serve.main()
    out = capfd.readouterr().out
    assert f"model={DEEPSEEK}-smoke" in out and "mesh=1,2" in out
    assert "finished=3/3" in out and out.count("finished=") == 1
