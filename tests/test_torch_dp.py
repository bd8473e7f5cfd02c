"""PyTorch port, data parallelism and the vocab-parallel head: gloo worlds
of (dp, tp) = (2, 1) and (2, 2) spawned on the CPU
(``repro_torch.launch.mesh.spawn`` running ``_torch_tp_rank.dp_job``;
inputs and outputs pass through ``tmp_path`` as numpy), each spawned once
(a module fixture) and running every case; the JAX references run in two
subprocesses beside them.

* the layout: rank r is (r // tp, r % tp); a tp all-reduce at dp = 2
  sums over the tp ranks only (2 at (2, 2), not 4), and the dp group
  gathers the ranks of one tp slice;
* ``llama-7b-paper`` smoke, on the adapter lifecycle of
  ``test_mesh_sharding.PARITY_SCRIPT`` (prefill, a mid-flight install, an
  evict, post-evict traffic) with nonzero adapter weights, padded and
  bucketed, einsum and sgmv, decode blocks 1 and 4, ``max_batch`` 4 (the
  slot batch splits over dp: each replica's cache holds 2 rows) and 3
  (every replica runs every slot): every rank's tokens equal the JAX
  single-device engine's, the JAX package's own promise for its mesh
  engine (``test_mesh_sharding.py``);
* ``zamba2-7b`` and ``rwkv6-7b`` smoke at (2, 1) and (2, 2): the
  recurrent state rows split over dp (and their heads over tp), tokens
  equal the JAX single-device engine's;
* ``deepseek-v2-lite-16b`` smoke at (2, 2) against the JAX mesh engine at
  (2, 2) (4 host devices): a group of 2 prompts of one repeated token,
  which dp splits (each replica routes its row's chunk at its own
  capacity), then a group of 3, which it does not; the expert-parallel
  path's capacity drops decide these tokens, and the JAX mesh engine at
  (1, 2) gives other ones;
* vocab-parallel: at tp 2 and 4 the embedding holds V/tp rows and the
  head V/tp columns, the slice drawn directly is the cut one, and the
  logits of a prefill and two decode steps equal the replicated head's
  at fp32 within 1e-6; V 510 splits at tp 2 and stays replicated at tp
  4 (the JAX ``fit_spec``); a tied embedding splits its rows the same
  way.
"""
import os
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest

import _torch_tp_rank as tp_rank
from _torch_jax_side import nonzero_weights
from repro.configs import get_smoke_config
from repro.models import model as JM
from repro_torch.launch.mesh import spawn

LLAMA, ZAMBA, RWKV = "llama-7b-paper", "zamba2-7b", "rwkv6-7b"
DEEPSEEK = "deepseek-v2-lite-16b"
WORLDS = [(2, 1), (2, 2)]
VOCAB = [("v512", {}), ("v510", {"vocab_size": 510}),
         ("tied", {"tie_embeddings": True})]
# the recurrent families' cases: both banks and both LoRA
# forms, decode blocks 1 and 4, the slot batch split (max_batch 4)
FAMILY_CASES = [("padded", "einsum", 1, 4), ("bucketed", "sgmv", 4, 4),
                ("padded", "sgmv", 4, 4), ("bucketed", "einsum", 1, 4)]
MOE_CASES = [("padded", "einsum", 1, 4), ("bucketed", "sgmv", 4, 4)]
SRC = os.path.join(os.path.dirname(__file__), os.pardir, "src")
HERE = os.path.dirname(__file__)

# the JAX engines, in two subprocesses with 4 host devices each
REF_SCRIPT = r"""
import pickle
import sys

import jax

assert len(jax.devices()) == 4, jax.devices()

import test_torch_dp as T

with open(sys.argv[1], "rb") as f:
    job = pickle.load(f)
out = T._references(job, T.REF_RUNS[int(sys.argv[3])])
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
print("REF_OK")
"""
# (arch, mesh or None, max_batch), dealt to two subprocesses
REF_RUNS = [[(DEEPSEEK, (2, 2), 4), (DEEPSEEK, (1, 2), 4)],
            [(LLAMA, None, 4), (LLAMA, None, 3), (ZAMBA, None, 4),
             (RWKV, None, 4)]]
TRACE = {LLAMA: "lifecycle", ZAMBA: "family", RWKV: "family",
         DEEPSEEK: "drops"}


def _arch_job(arch, seed, cases):
    cfg = get_smoke_config(arch)
    params = jax.tree.map(np.asarray,
                          JM.init_params(cfg, jax.random.PRNGKey(seed)))
    if arch == DEEPSEEK:
        # the routed experts' output large beside the rest of the residual
        # stream, so that a dropped assignment moves the tokens
        params["blocks"]["ffn"]["we2"] = params["blocks"]["ffn"]["we2"] * 30
    if arch == LLAMA:
        ranks = {**tp_rank.RANKS, tp_rank.LATE[0]: tp_rank.LATE[1]}
        engine_ranks, max_len = dict(tp_rank.RANKS), 40
    else:
        ranks = engine_ranks = dict(tp_rank.FAMILY_RANKS)
        max_len = 24
    return {"params": params, "weights": nonzero_weights(cfg, ranks, seed),
            "ranks": engine_ranks, "trace": TRACE[arch], "max_len": max_len,
            "cases": cases}


def _references(job, runs):
    """The JAX engines' tokens, {(arch, mesh, max_batch): tokens}, padded
    and einsum at decode block 1 (the JAX package's own tests hold its
    bank modes, kernels and decode blocks to the same tokens)."""
    import time

    import jax.numpy as jnp

    from repro.launch.mesh import make_engine_mesh
    from repro.serving import Request as JRequest
    from repro.serving import ServingEngine as JEngine
    out = {}
    for arch, mesh, mb in runs:
        a = job["archs"][arch]
        cfg = get_smoke_config(arch)
        eng = JEngine(cfg, jax.tree.map(jnp.asarray, a["params"]),
                      dict(a["ranks"]), max_batch=mb, max_len=a["max_len"],
                      bank_mode="padded", lora_kernel="einsum",
                      mesh=None if mesh is None else make_engine_mesh(*mesh))
        weights = {aid: jax.tree.map(jnp.asarray, w)
                   for aid, w in a["weights"].items()}
        out[(arch, mesh, mb)] = tp_rank.DP_TRACES[a["trace"]](
            eng, lambda *r: JRequest(*r, arrival=time.monotonic()), weights)
    return out


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Every world's job, and the JAX subprocesses, started here so that
    they run beside the ranks."""
    tmp = tmp_path_factory.mktemp("dp")
    llama = tp_rank.DP_CASES
    jobs = {
        (2, 1): {LLAMA: _arch_job(LLAMA, 0, llama),
                 ZAMBA: _arch_job(ZAMBA, 1, FAMILY_CASES),
                 RWKV: _arch_job(RWKV, 2, FAMILY_CASES)},
        (2, 2): {LLAMA: _arch_job(LLAMA, 0, llama),
                 ZAMBA: _arch_job(ZAMBA, 1, FAMILY_CASES),
                 RWKV: _arch_job(RWKV, 2, FAMILY_CASES),
                 DEEPSEEK: _arch_job(DEEPSEEK, 3, MOE_CASES)}}
    for world, archs in jobs.items():
        with open(tmp / f"job{world[0]}x{world[1]}.pkl", "wb") as f:
            pickle.dump({"archs": archs, "vocab": VOCAB}, f)
    ref_archs = {a: j for archs in jobs.values() for a, j in archs.items()}
    with open(tmp / "ref_job.pkl", "wb") as f:
        pickle.dump({"archs": ref_archs}, f)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        [SRC, HERE, env.get("PYTHONPATH", "")])
    procs = [subprocess.Popen(
        [sys.executable, "-c", REF_SCRIPT, str(tmp / "ref_job.pkl"),
         str(tmp / f"ref_out{i}.pkl"), str(i)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env)
        for i in range(len(REF_RUNS))]
    yield {"tmp": tmp, "jobs": jobs, "procs": procs}
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


@pytest.fixture(scope="module")
def worlds(setup):
    """{(dp, tp): every rank's outputs}, the worlds spawned one after the
    other."""
    tmp = setup["tmp"]
    out = {}
    for dp, tp in WORLDS:
        d = tmp / f"w{dp}x{tp}"
        d.mkdir()
        spawn(tp_rank.dp_job, dp * tp, backend="gloo", init_file=d / "init",
              args=(dp, tp, str(tmp / f"job{dp}x{tp}.pkl"), str(d)))
        ranks = []
        for r in range(dp * tp):
            with open(d / f"dp{r}.pkl", "rb") as f:
                ranks.append(pickle.load(f))
        out[(dp, tp)] = ranks
    return out


@pytest.fixture(scope="module")
def refs(setup):
    out = {}
    for i, proc in enumerate(setup["procs"]):
        so, se = proc.communicate(timeout=600)
        assert proc.returncode == 0 and "REF_OK" in so, so + se
        with open(setup["tmp"] / f"ref_out{i}.pkl", "rb") as f:
            out.update(pickle.load(f))
    return out


@pytest.mark.parametrize("world", WORLDS, ids=lambda w: f"{w[0]}x{w[1]}")
def test_mesh_layout_groups(worlds, world):
    dp, tp = world
    outs = worlds[world]
    for r, o in enumerate(outs):
        assert o["coords"] == (r // tp, r % tp)
        # the tp all-reduce sums the tp ranks of this dp replica only
        assert o["tp_sum"] == tp
        # the dp group: the ranks that hold this rank's tp slice
        assert o["dp_gather"] == [float(i * tp + r % tp) for i in range(dp)]


@pytest.mark.parametrize("world", WORLDS, ids=lambda w: f"{w[0]}x{w[1]}")
@pytest.mark.parametrize("case", tp_rank.DP_CASES,
                         ids=lambda c: "/".join(map(str, c)))
def test_llama_tokens_match_jax(worlds, refs, world, case):
    want = refs[(LLAMA, None, case[3])]
    assert len(want) == 6 and all(len(v) == 5 for v in want.values())
    dp = world[0]
    for r, o in enumerate(worlds[world]):
        assert o["engine"][(LLAMA, *case)] == want, (world, case, r)
        # 4 slots split over dp; 3 do not
        rows = case[3] // dp if case[3] % dp == 0 else case[3]
        assert o["cache_rows"][(LLAMA, *case)] == rows


@pytest.mark.parametrize("world", WORLDS, ids=lambda w: f"{w[0]}x{w[1]}")
@pytest.mark.parametrize("arch", [ZAMBA, RWKV])
@pytest.mark.parametrize("case", FAMILY_CASES,
                         ids=lambda c: "/".join(map(str, c)))
def test_recurrent_state_rows_match_jax(worlds, refs, world, arch, case):
    want = refs[(arch, None, 4)]
    assert len(want) == 6 and all(len(v) == 4 for v in want.values())
    for r, o in enumerate(worlds[world]):
        assert o["engine"][(arch, *case)] == want, (arch, case, r)
        assert o["cache_rows"][(arch, *case)] == 2


@pytest.mark.parametrize("case", MOE_CASES,
                         ids=lambda c: "/".join(map(str, c)))
def test_moe_capacity_matches_the_jax_mesh(worlds, refs, case):
    want = refs[(DEEPSEEK, (2, 2), 4)]
    assert len(want) == 5 and all(len(v) == 4 for v in want.values())
    # the dp split decides these tokens: without it (the JAX mesh at
    # (1, 2)) the first group's capacity drops other rows
    assert refs[(DEEPSEEK, (1, 2), 4)] != want
    L = get_smoke_config(DEEPSEEK).n_layers
    for r, o in enumerate(worlds[(2, 2)]):
        assert o["engine"][(DEEPSEEK, *case)] == want, (case, r)
        # the 2-row group split over dp (2 rows, then 1 a replica), the
        # 3-row group whole on each replica
        assert o["ep_rows"][(DEEPSEEK, *case)] == {2: L, 1: L, 3: L}
        # the split group's shards drop nothing, the whole one's do
        drops = o["ep_drops"][(DEEPSEEK, *case)]
        assert drops[1] == 0 and drops[3] > 0, drops


@pytest.mark.parametrize("world", WORLDS, ids=lambda w: f"tp{w[0] * w[1]}")
@pytest.mark.parametrize("name", [v[0] for v in VOCAB])
def test_vocab_parallel_head(worlds, world, name):
    tp = world[0] * world[1]
    cfg = get_smoke_config(LLAMA)
    V = dict(VOCAB)[name].get("vocab_size", cfg.vocab_size)
    rows = V // tp if V % tp == 0 else V
    for o in worlds[world]:
        v = o["vocab"][name]
        assert v["embed"] == (rows, cfg.d_model)
        assert v["lm_head"] == (None if name == "tied"
                                else (cfg.d_model, rows))
        assert v["drawn_is_cut"]
        for got, want in zip(v["split"], v["repl"]):
            assert got.shape == (3, V)
            np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    if name == "v510":
        assert (rows == V) == (tp == 4)
