"""PyTorch port, the tensor-parallel engine (``ServingEngine(mesh=...)``):
ranks spawned over gloo on the CPU at tp = 2 and 4
(``repro_torch.launch.mesh.spawn`` running ``_torch_tp_rank.rank_job``;
inputs and outputs pass through ``tmp_path`` as numpy, so the ranks import
neither JAX nor this file), on ``llama-7b-paper-smoke`` with bridged JAX
weights and nonzero-B banks:

* the co-sharded LoRA deltas (einsum and SGMV, padded and bucketed; the
  SGMV forms on the plain versions of B3a/B3b and B4a/B4b) put side by
  side equal the JAX single-device delta, fp32 1e-5 (the all-reduce
  reorders the d-sum), and each rank's delta is the same bits with its
  index tensor in a ``LayoutPlan`` (the SGMV forms build one layout);
* on the lifecycle trace of ``test_mesh_sharding.PARITY_SCRIPT`` (with the
  weights installed after every rebuild) each rank emits exactly the JAX
  single-device engine's tokens, in the JAX test's four cases and
  padded/sgmv; the JAX side runs gather-einsum, which its own suite
  proves equal to its kernels;
* every rank emits the same tokens, the ranks' param slices put the full
  module back together, and a tp engine gives a peer full-width adapter
  weights;
* the layout refuses a mesh outside a world or of no ranks, a missing
  process group and an indivisible config, and builds a rank's layout of the recurrent, VLM and audio
  families (``test_torch_tp_families.py`` serves them); the launcher
  serves with ``--mesh 1,2 --backend gloo``.

Each world size is spawned once (a module fixture) and runs every case.
"""
import pickle
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_tp_rank as tp_rank
from repro.configs import get_smoke_config
from repro.lora.bank import build_bank as jax_build_bank
from repro.lora.batched import make_lora_cb as jax_make_lora_cb
from repro.models import model as JM
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine
from repro_torch import bridge
from repro_torch.launch.mesh import TensorParallel, make_engine_mesh, spawn
from repro_torch.models import model as TM
from repro_torch.serving.sharding import EngineSharding

MODEL = "llama-7b-paper"
CASES = [("padded", "einsum", 1), ("bucketed", "einsum", 1),
         ("bucketed", "einsum", 4), ("bucketed", "sgmv", 1),
         ("padded", "sgmv", 1)]
DELTA_FORMS = [("padded", "einsum"), ("padded", "sgmv"),
               ("bucketed", "einsum"), ("bucketed", "sgmv")]
ALL_RANKS = {**tp_rank.RANKS, tp_rank.LATE[0]: tp_rank.LATE[1]}


def _weights(cfg, seed=5):
    rng = np.random.default_rng(seed)
    L, d = cfg.n_layers, cfg.d_model
    return {aid: {t: {"A": (rng.standard_normal((L, d, r)) * 0.2
                            ).astype(np.float32),
                      "B": (rng.standard_normal((L, r, d)) * 0.2
                            ).astype(np.float32)}
                  for t in cfg.lora.targets}
            for aid, r in ALL_RANKS.items()}


def _delta_job(cfg, weights, mode, kernel):
    """One delta case: a JAX bank with the nonzero weights, its numpy
    fields, inputs, and the JAX single-device delta at layer 0."""
    jb = jax_build_bank(cfg, ALL_RANKS, jax.random.PRNGKey(1), mode=mode)
    for aid, w in weights.items():
        jb = jb.set_adapter(aid, jax.tree.map(jnp.asarray, w))
    rng = np.random.default_rng(7)
    gi = np.array([0, 2, 1, 2, 0], np.int32)
    idx = np.asarray(jb.lora_idx(jnp.asarray(gi)))
    x = {t: rng.standard_normal((len(gi), 3, cfg.d_model)).astype(np.float32)
         for t in ("q", "o")}
    data = jb.data if mode == "bucketed" else (jb.data,)
    layer = tuple({t: {k: w[k][0] for k in ("A", "B")} for t, w in b.items()}
                  for b in data)
    cb = jax_make_lora_cb(layer if mode == "bucketed" else layer[0],
                          jnp.asarray(idx), kernel=kernel, interpret=True)
    want = {t: np.asarray(cb(t, jnp.asarray(v))) for t, v in x.items()}
    fields = dict(mode=jb.mode, adapter_ids=jb.adapter_ids, ranks=jb.ranks,
                  data=jax.tree.map(np.asarray, jb.data),
                  bucket_ranks=jb.bucket_ranks,
                  bucket_counts=jb.bucket_counts,
                  **{k: None if getattr(jb, k) is None
                     else np.asarray(getattr(jb, k))
                     for k in ("adapter_bucket", "adapter_local")})
    return {"mode": mode, "kernel": kernel, "bank": fields, "idx": idx,
            "x": x}, want


@pytest.fixture(scope="module")
def setup():
    cfg = get_smoke_config(MODEL)
    jp = JM.init_params(cfg, jax.random.PRNGKey(0))
    weights = _weights(cfg)
    deltas, want = [], {}
    for mode, kernel in DELTA_FORMS:
        job, w = _delta_job(cfg, weights, mode, kernel)
        deltas.append(job)
        want.update({(mode, kernel, t): y for t, y in w.items()})
    job = {"model": MODEL, "params": jax.tree.map(np.asarray, jp),
           "weights": weights, "cases": CASES, "deltas": deltas}
    return cfg, jp, weights, job, want


@pytest.fixture(scope="module")
def jax_tokens(setup):
    """The JAX single-device engine on the lifecycle trace, one run per
    (bank_mode, decode_block)."""
    cfg, jp, weights, _, _ = setup
    jw = {aid: jax.tree.map(jnp.asarray, w) for aid, w in weights.items()}
    out = {}
    for mode, _, k in CASES:
        if (mode, k) not in out:
            eng = JaxEngine(cfg, jp, dict(tp_rank.RANKS), max_batch=4,
                            max_len=40, bank_mode=mode, lora_kernel="einsum",
                            decode_block=k)
            out[(mode, k)] = tp_rank.lifecycle(
                eng, lambda *a: JaxRequest(*a, arrival=time.monotonic()), jw)
    return out


@pytest.fixture(scope="module", params=[2, 4], ids=["tp2", "tp4"])
def ranks(request, setup, tmp_path_factory):
    """Every rank's outputs of one spawned world of ``request.param``."""
    tp = request.param
    tmp = tmp_path_factory.mktemp(f"tp{tp}")
    with open(tmp / "job.pkl", "wb") as f:
        pickle.dump(setup[3], f)
    spawn(tp_rank.rank_job, tp, backend="gloo", init_file=tmp / "init",
          args=(tp, str(tmp / "job.pkl"), str(tmp)))
    outs = []
    for r in range(tp):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            outs.append(pickle.load(f))
    return tp, outs


@pytest.mark.parametrize("form", DELTA_FORMS, ids="/".join)
def test_coshard_delta_matches_jax(setup, ranks, form):
    want = setup[4]
    _, outs = ranks
    for t in ("q", "o"):
        got = np.concatenate([o["delta"][(*form, t)] for o in outs], -1)
        np.testing.assert_allclose(got, want[(*form, t)], atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("form", DELTA_FORMS, ids="/".join)
def test_coshard_delta_with_a_layout_plan_equals_without(ranks, form):
    """On every rank, the hook given its index tensor in a ``LayoutPlan``
    gives the co-sharded delta of the plain tensor bit for bit; the SGMV
    forms' plan builds one layout for both targets (the same tokens and
    block_t), the einsum forms' none."""
    _, outs = ranks
    for o in outs:
        for t in ("q", "o"):
            np.testing.assert_array_equal(o["plan_delta"][(*form, t)],
                                          o["delta"][(*form, t)])
        assert o["plan_builds"][form] == (form[1] == "sgmv")


@pytest.mark.parametrize("case", CASES, ids=lambda c: "/".join(map(str, c)))
def test_tp_engine_tokens_match_jax(jax_tokens, ranks, case):
    mode, _, k = case
    _, outs = ranks
    want = jax_tokens[(mode, k)]
    assert len(want) == 6 and all(len(v) == 5 for v in want.values())
    for rank, o in enumerate(outs):
        assert o["engine"][case] == want, (rank, case)


def test_ranks_agree_and_slices_reassemble(setup, ranks):
    cfg, jp, weights, _, _ = setup
    tp, outs = ranks
    for o in outs[1:]:
        assert o["engine"] == outs[0]["engine"]
    full = bridge.params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                                    device="cpu")
    bridge.check_shards(cfg, full, [o["shards"] for o in outs])
    assert outs[0]["shards"]["blocks.0.attn.wq"].shape == (
        cfg.d_model, cfg.d_model // tp)
    bad = [dict(o["shards"]) for o in outs]
    bad[0], bad[-1] = bad[-1], bad[0]            # ranks out of order
    with pytest.raises(ValueError, match="back together"):
        bridge.check_shards(cfg, full, bad)
    for o in outs:                   # a peer reads full-width weights
        for t, w in weights["a-r8"].items():
            np.testing.assert_array_equal(o["adapter_weights"][t]["A"],
                                          w["A"])
            np.testing.assert_array_equal(o["adapter_weights"][t]["B"],
                                          w["B"])


def test_layout_refusals(monkeypatch):
    from repro_torch.launch import serve
    # dp > 1 is served (test_torch_dp.py); outside a world it is refused
    with pytest.raises(RuntimeError, match="launch.mesh.spawn"):
        make_engine_mesh(2, 2, device="cpu")
    monkeypatch.setattr("sys.argv", ["serve", "--config", "smoke",
                                     "--device", "cpu", "--mesh", "0,2"])
    with pytest.raises(ValueError, match="positive"):
        serve.main()
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        make_engine_mesh(1, 2, device="cpu")
    assert make_engine_mesh(1, 1, device="cpu").size == 1
    cfg = get_smoke_config(MODEL)
    with pytest.raises(ValueError, match="divisible"):
        EngineSharding(TensorParallel(None, 0, 3), cfg)
    # the recurrent, VLM and audio families are sharded too: a rank's
    # layout builds, its slices hold the rank's heads
    for arch in ("zamba2-7b", "rwkv6-7b", "llama-3.2-vision-90b",
                 "seamless-m4t-large-v2"):
        cfg = get_smoke_config(arch)
        sh = EngineSharding(TensorParallel(None, 1, 2), cfg)
        part = sh.shard_params(TM.init_params(cfg, 0, device="cpu"))
        assert part.tp_shard == (1, 2)
        w = dict(part.named_parameters())
        if cfg.family == "hybrid":
            assert w["mamba_blocks.0.w_dt"].shape[1] * 2 == \
                TM.mamba_dims(cfg)[1]
        elif cfg.family == "ssm":
            assert w["blocks.0.w_r"].shape == (cfg.d_model, cfg.d_model // 2)
        else:
            name = "cross_blocks.0.attn.wk" if cfg.family == "vlm" \
                else "dec_blocks.0.cross.wk"
            assert w[name].shape[1] == cfg.n_kv_heads // 2 * \
                cfg.resolved_head_dim


def test_launcher_serves_tensor_parallel(monkeypatch, capfd):
    from repro_torch.launch import serve
    monkeypatch.setattr("sys.argv", [
        "serve", "--config", "smoke", "--device", "cpu", "--mesh", "1,2",
        "--backend", "gloo", "--requests", "3", "--prompt-lens", "4,6",
        "--max-new", "3", "--bank-mode", "bucketed", "--dtype", "float32"])
    serve.main()
    out = capfd.readouterr().out
    assert "finished=3/3" in out and "mesh=1,2" in out
    assert out.count("finished=") == 1          # rank 0 reports
