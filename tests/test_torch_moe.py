"""PyTorch port, the MoE family: ``models/ffn.py:moe_ffn`` and the two MoE
models the port serves — deepseek-v2-lite-16b (MLA attention, top-k
experts, shared experts) and llama4-scout-17b-a16e (GQA, top-1) — held
against the JAX package at their smoke configs, with params and nonzero-B
LoRA banks made in JAX and bridged through numpy:

* ``moe_ffn`` (outputs, the balance loss) on a prefill batch, a decode
  batch and a batch past the drop-free size (8200 tokens, one expert
  favoured so that its capacity drops tokens); the expert ids, the
  sorted tokens and ``dest`` exactly;
* the router stays fp32 through ``init_params`` and ``bridge`` at bf16;
* ``prefill`` and ``decode_step`` logits and every cache entry in both
  bank modes, the port with ``einsum`` and ``sgmv`` (its kernels' plain
  versions) against the JAX package's ``sgmv`` (its Pallas kernels in
  interpret mode; its own suite holds its einsum path equal to them);
* the engine's tokens against the JAX engine's, both bank modes,
  decode_block 1 and 4;
* prefill + one decode step against the prefill of one more token (the
  MoE form of ``test_models_smoke.test_prefill_decode_consistency``);
* the tensor-parallel layout refuses MoE and MLA;
* every SGMV wrapper takes the two models' full widths (d 2048 and 5120;
  d_out 3072, 576, 2048, 5120 and 1024) and hands them to the library
  unchanged, with the shrink split of the width (a fake card).

Tolerances: fp32 atol = rtol = 1e-4 (``tests/test_torch_models.py``'s:
the two frameworks sum in different orders); routing and tokens exact.
"""
import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_jax_side import nonzero_weights
from repro.configs import get_smoke_config
from repro.lora.bank import build_bank as jax_build_bank
from repro.models import ffn as JF
from repro.models import model as JM
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.launch.mesh import TensorParallel
from repro_torch.lora.adapter import _target_in_dim, _target_out_dim
from repro_torch.models import ffn as TF
from repro_torch.models import model as TM
from repro_torch.serving import Request, ServingEngine
from repro_torch.serving.sharding import EngineSharding

ARCHS = ["deepseek-v2-lite-16b", "llama4-scout-17b-a16e"]
# ranks at most the smoke configs' narrowest d_out (deepseek's k: 40): the
# reference's pad_rank tells A from B by shape (ROADMAP C10)
ADAPTERS = {"a-r8": 8, "b-r32": 32, "c-r16": 16}
ATOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), atol=atol,
                               rtol=atol)


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    cfg = get_smoke_config(request.param)
    jp = JM.init_params(cfg, jax.random.PRNGKey(0))
    tp = bridge.params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                                  device="cpu")
    return cfg, jp, tp


# ---------------------------------------------------------------------------
# moe_ffn
# ---------------------------------------------------------------------------


def _moe_input(cfg, router, shape, favour):
    """(shape + (d,)) fp32 normal inputs; ``favour`` shifts every token
    toward expert 0 (its router logit up by 10), so that its capacity
    drops tokens past the drop-free size."""
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal(shape + (cfg.d_model,)).astype(np.float32)
    if favour:
        r0 = np.asarray(router)[:, 0]
        x = x + (10.0 * r0 / (r0 @ r0)).astype(np.float32)
    return x


@pytest.mark.parametrize("shape", [(2, 7), (5, 1), (1, 8200)],
                         ids=["prefill", "decode", "past-drop-free"])
def test_moe_ffn_matches_jax(setup, shape):
    cfg, jp, tp = setup
    jffn = jax.tree.map(lambda a: a[0], jp["blocks"]["ffn"])
    tffn = tp.blocks[0].ffn
    N, K = shape[0] * shape[1], cfg.moe.top_k
    x = _moe_input(cfg, jffn["router"], shape, favour=N > 8192)
    yj, auxj = JF.moe_ffn(cfg, jffn, jnp.asarray(x))
    yt, auxt = TF.moe_ffn(cfg, tffn, _t(x))
    _close(yt, yj)
    _close(auxt, auxj)
    # routing, exactly: the JAX package's sort-pack of the same tokens
    xf = x.reshape(N, cfg.d_model)
    _, tok_s, _, keep, dest, C, _ = JF._route_pack(
        cfg, jffn["router"], jnp.asarray(xf), 1.25)
    probs = jax.nn.softmax(jnp.asarray(xf) @ jffn["router"], axis=-1)
    topi_j = np.asarray(jax.lax.top_k(probs, K)[1])
    _, topi, order, dest_t, C_t, _ = TF.moe_route(cfg, tffn.router, _t(xf))
    np.testing.assert_array_equal(topi.numpy(), topi_j)
    np.testing.assert_array_equal((order // K).numpy(), np.asarray(tok_s))
    np.testing.assert_array_equal(dest_t.numpy(), np.asarray(dest))
    assert C_t == C == TF.moe_capacity(N, K, cfg.moe.n_experts, 1.25)
    # experts repeat in every batch; past 8192 tokens the favoured
    # expert's capacity drops some, below it none are dropped
    assert len(set(topi_j.reshape(-1).tolist())) < N * K
    assert bool(np.asarray(keep).all()) == (N <= 8192)


def test_moe_capacity_is_drop_free_up_to_8192_tokens():
    assert TF.moe_capacity(8192, 6, 64, 1.25) == 8192
    assert TF.moe_capacity(8193, 6, 64, 1.25) == 961      # ceil(768.1..*1.25)
    assert TF.moe_capacity(10_000, 1, 16, 1.25) == 782


def test_router_stays_fp32_at_bf16(setup):
    cfg, jp, _ = setup
    tree = jax.tree.map(np.asarray, jp)
    lm = bridge.params_from_numpy(cfg, tree, device="cpu",
                                  dtype=torch.bfloat16)
    for i, bp in enumerate(lm.blocks):
        assert bp.ffn.router.dtype == torch.float32
        np.testing.assert_array_equal(bp.ffn.router.numpy(),
                                      tree["blocks"]["ffn"]["router"][i])
        assert bp.ffn.we1.dtype == torch.bfloat16
    fresh = TM.init_params(cfg, 0, dtype=torch.bfloat16, device="cpu")
    assert {n for n, p in fresh.named_parameters()
            if p.dtype == torch.float32} == {
        f"blocks.{i}.ffn.router" for i in range(cfg.n_layers)}


# ---------------------------------------------------------------------------
# prefill / decode against the JAX model
# ---------------------------------------------------------------------------


def _jax_bank(cfg, mode, weights):
    bank = jax_build_bank(cfg, ADAPTERS, jax.random.PRNGKey(1), mode=mode)
    for aid, w in weights.items():
        bank = bank.set_adapter(aid, jax.tree.map(jnp.asarray, w))
    return bank


def _bridge_bank(cfg, jb):
    opt = {k: None if getattr(jb, k) is None else np.asarray(getattr(jb, k))
           for k in ("adapter_bucket", "adapter_local")}
    return bridge.bank_from_numpy(cfg, dict(
        mode=jb.mode, adapter_ids=jb.adapter_ids, ranks=jb.ranks,
        data=jax.tree.map(np.asarray, jb.data), bucket_ranks=jb.bucket_ranks,
        bucket_counts=jb.bucket_counts, **opt), device="cpu")


TOKS = np.array([[5, 9, 2, 7, 1, 3], [8, 8, 4, 6, 2, 11],
                 [3, 1, 4, 1, 5, 9]], np.int32)
ROWS = np.array([0, 1, 2], np.int32)


@pytest.fixture(scope="module")
def jax_runs(setup):
    """JAX prefill + one decode step per bank mode, its SGMV kernels in
    interpret mode."""
    cfg, jp, _ = setup
    weights = nonzero_weights(cfg, ADAPTERS, 5)
    out = {}
    for mode in ("padded", "bucketed"):
        jb = _jax_bank(cfg, mode, weights)
        idx = jb.lora_idx(jnp.asarray(ROWS))
        lp, cache = JM.prefill(cfg, jp, jnp.asarray(TOKS), bank=jb.data,
                               lora_idx=idx, cache_len=10,
                               cache_dtype=jnp.float32, lora_kernel="sgmv")
        nxt = np.asarray(jnp.argmax(lp, axis=-1)).astype(np.int32)
        ld, cache2 = JM.decode_step(cfg, jp, cache, jnp.asarray(nxt),
                                    bank=jb.data, lora_idx=idx,
                                    lora_kernel="sgmv")
        out[mode] = (jb, np.asarray(lp), nxt, np.asarray(ld),
                     {k: np.asarray(v) for k, v in cache2.items()})
    return out


@pytest.mark.parametrize("mode", ["padded", "bucketed"])
@pytest.mark.parametrize("kernel", ["einsum", "sgmv"])
def test_prefill_decode_logits_and_caches_match_jax(setup, jax_runs, mode,
                                                    kernel):
    cfg, _, tp = setup
    jb, lp, nxt, ld, cache_j = jax_runs[mode]
    tb = _bridge_bank(cfg, jb)
    idx = tb.lora_idx(_t(ROWS))
    lt, cache = TM.prefill(cfg, tp, _t(TOKS), bank=tb.data, lora_idx=idx,
                           cache_len=10, cache_dtype=torch.float32,
                           lora_kernel=kernel)
    _close(lt, lp)
    np.testing.assert_array_equal(lt.argmax(-1).numpy(), nxt)
    ldt, cache2 = TM.decode_step(cfg, tp, cache, _t(nxt), bank=tb.data,
                                 lora_idx=idx, lora_kernel=kernel)
    _close(ldt, ld)
    want = {"c", "kr", "pos"} if cfg.mla else {"k", "v", "pos"}
    assert set(cache2) == set(cache_j) == want
    for key in want - {"pos"}:
        _close(cache2[key], cache_j[key])
    assert cache2["pos"].tolist() == cache_j["pos"].tolist() == [7] * 3


def test_lora_delta_moves_the_logits(setup, jax_runs):
    """The bridged nonzero-B bank moves the logits: a delta lost on the way
    would not pass the parity test above silently."""
    cfg, _, tp = setup
    lt, _ = TM.prefill(cfg, tp, _t(TOKS), cache_len=10)
    assert np.abs(lt.numpy() - jax_runs["padded"][1]).max() > 1e-2


def test_prefill_decode_consistency(setup):
    """Decode after prefill matches the prefill of one more token (the
    port's counterpart of the JAX suite's teacher-forced check): the
    expert capacity is drop-free at both sizes, so routing agrees."""
    cfg = setup[0]
    params = TM.init_params(cfg, 2, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 11)).astype(np.int32))
    full, _ = TM.prefill(cfg, params, tokens)
    _, cache = TM.prefill(cfg, params, tokens[:, :10], cache_len=14)
    dec, _ = TM.decode_step(cfg, params, cache, tokens[:, 10])
    rel = (full - dec).abs().max() / (full.abs().max() + 1e-9)
    assert rel < 1e-3, rel


# ---------------------------------------------------------------------------
# the engine against the JAX engine
# ---------------------------------------------------------------------------


def _trace(cfg):
    rng = np.random.default_rng(1)
    ids = sorted(ADAPTERS)
    return [(ids[i % 3], [int(t) for t in rng.integers(1, cfg.vocab_size,
                                                        6 + i % 2)],
             3 + i % 3) for i in range(5)]


def _serve(setup, weights, *, jax_side, **kw):
    cfg, jp, tp = setup
    if jax_side:
        eng = JaxEngine(cfg, jp, dict(ADAPTERS), max_batch=4, max_len=20,
                        lora_kernel="einsum")
        mk, conv = JaxRequest, lambda w: jax.tree.map(jnp.asarray, w)
    else:
        eng = ServingEngine(cfg, tp, dict(ADAPTERS), max_batch=4,
                            max_len=20, device="cpu", **kw)
        mk, conv = Request, lambda w: bridge.adapter_weights_from_numpy(
            w, device="cpu")
    for aid, r in ADAPTERS.items():
        eng.install_adapter(aid, r, conv(weights[aid]))
    now = time.monotonic()
    reqs = [mk(i, aid, p, n, arrival=now)
            for i, (aid, p, n) in enumerate(_trace(cfg))]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained(max_iters=200)
    return [r.output for r in reqs], eng


@pytest.fixture(scope="module")
def jax_engine_run(setup):
    weights = nonzero_weights(setup[0], ADAPTERS, 6)
    return weights, _serve(setup, weights, jax_side=True)[0]


@pytest.mark.parametrize("bank_mode", ["padded", "bucketed"])
@pytest.mark.parametrize("decode_block", [1, 4])
def test_engine_tokens_match_jax_engine(setup, jax_engine_run, bank_mode,
                                        decode_block):
    weights, want = jax_engine_run
    out, eng = _serve(setup, weights, jax_side=False, bank_mode=bank_mode,
                      decode_block=decode_block, lora_kernel="sgmv")
    assert out == want
    assert eng.metrics.finished == len(want)
    assert set(eng.cache) == ({"c", "kr", "pos"} if setup[0].mla
                              else {"k", "v", "pos"})


# ---------------------------------------------------------------------------
# refusals and the kernels' full widths
# ---------------------------------------------------------------------------


def test_tensor_parallel_refuses_moe_and_mla(setup):
    """Once refused, now served (``test_torch_tp_families.py``): a tp = 2
    rank's layout of the MoE layer (its E/2 experts, its columns of the
    shared experts, the router whole) and of MLA (its heads; the latent
    projection whole) builds, and so does its engine; an expert count
    that tp does not divide is still refused."""
    cfg, _, tp = setup
    mesh = TensorParallel(None, 1, 2)
    part = EngineSharding(mesh, cfg).shard_params(tp)
    ffn, attn = part.blocks[0].ffn, part.blocks[0].attn
    e = cfg.moe
    assert ffn.we1.shape == (e.n_experts // 2, cfg.d_model, e.d_ff_expert)
    torch.testing.assert_close(ffn.we1, tp.blocks[0].ffn.we1[
        e.n_experts // 2:], rtol=0, atol=0)
    assert ffn.router is tp.blocks[0].ffn.router
    if e.n_shared_experts:
        assert ffn.ws2.shape[0] * 2 == e.n_shared_experts * e.d_ff_expert
    if cfg.mla is not None:
        assert attn.w_uk.shape[1] * 2 == cfg.n_heads * \
            cfg.mla.qk_nope_head_dim
        assert attn.w_dkv is tp.blocks[0].attn.w_dkv
    else:
        assert attn.wq.shape[1] * 2 == cfg.n_heads * cfg.resolved_head_dim
    eng = ServingEngine(cfg, tp, dict(ADAPTERS), mesh=mesh, device="cpu")
    assert eng.cache["c" if cfg.mla else "k"].shape[3] == (
        cfg.mla.kv_lora_rank if cfg.mla else cfg.n_kv_heads // 2)
    with pytest.raises(ValueError, match="n_experts"):
        EngineSharding(TensorParallel(None, 0, 8),
                       dataclasses.replace(cfg, n_heads=8, d_model=128))


def _full_widths():
    """(arch, target, d, d_out) of every LoRA call of the two models at
    full width; MLA's v is in the bank but never called."""
    out = []
    for arch in ARCHS:
        cfg = get_config(arch)
        for t in cfg.lora.targets:
            if cfg.mla is not None and t == "v":
                continue
            out.append((arch, t, _target_in_dim(cfg, t),
                        _target_out_dim(cfg, t)))
    return out


FULL_WIDTHS = _full_widths()


def test_full_widths_are_the_expected_ones():
    assert sorted({(d, do) for _, _, d, do in FULL_WIDTHS}) == [
        (2048, 576), (2048, 2048), (2048, 3072), (5120, 1024), (5120, 5120)]


@pytest.mark.parametrize("arch,target,d,d_out", FULL_WIDTHS)
def test_wrappers_take_the_full_widths(monkeypatch, arch, target, d, d_out):
    """B1, B2 (block_t 16 and 64), B3a, B3b, B4a and B4b at the width:
    meta tensors stand in for CUDA ones, the library call records its
    arguments; nothing refuses, d and d_out reach the library as they
    are, and the shrink's split is 16 (a 128-row slice at 2048, 320 at
    5120)."""
    from repro_torch.kernels import sgmv as tsgmv
    calls = []
    monkeypatch.setattr(tsgmv, "_CARD", "meta")
    monkeypatch.setattr(tsgmv, "_launch", lambda name, device, *args:
                        calls.append((name, args)))

    def meta(*shape, dtype=torch.bfloat16):
        return torch.empty(shape, dtype=dtype, device="meta")

    r = 128
    A, B = meta(5, d, r), meta(5, r, d_out)
    banks = [(meta(2, d, 8), meta(2, 8, d_out)), (A, B)]
    for bt in (16, 64):
        x, idx = meta(4 * bt, d), meta(4, dtype=torch.int32)
        tsgmv.sgmv_multibank_blocks(x, banks, idx, idx, block_t=bt)
    x, idx = meta(64, d), meta(4, dtype=torch.int32)
    tsgmv.sgmv_fused_blocks(x, A, B, idx)
    tsgmv.sgmv_shrink(x, A, idx)
    tsgmv.sgmv_expand(meta(64, r), B, idx)
    tsgmv.sgmv_multibank_shrink(x, [a for a, _ in banks], idx, idx)
    tsgmv.sgmv_multibank_expand(meta(64, r), [b for _, b in banks], idx, idx)
    got = {name: args for name, args in calls}
    assert len(calls) == 7
    assert got["sgmv_fused_blocks_launch"][-3:] == (d, r, d_out)
    assert got["sgmv_multibank_blocks_launch"][-2:] == (d, d_out)
    assert got["sgmv_shrink_launch"][-2:] == (d, r)
    assert got["sgmv_expand_launch"][-2:] == (r, d_out)
    assert got["sgmv_multibank_shrink_launch"][-2:] == (d, r)
    assert got["sgmv_multibank_expand_launch"][-2:] == (r, d_out)
    for name in ("sgmv_fused_blocks_launch", "sgmv_multibank_blocks_launch",
                 "sgmv_shrink_launch", "sgmv_multibank_shrink_launch"):
        assert got[name][1] == tsgmv.shrink_split(d, torch.bfloat16) == 16
