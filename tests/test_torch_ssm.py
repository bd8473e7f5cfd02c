"""PyTorch port, the state-space blocks (``repro_torch.models.ssm``) held
against the JAX package's ``models/ssm.py``: Mamba2's full-sequence and
step forms and RWKV-6's time and channel mix, on the same numpy inputs
from a seed, with each block's weights made in JAX (every leaf moved off
its init value, so zero biases and unit scales are exercised) and
bridged through numpy. RWKV-6's time mix runs with a LoRA callback whose
four targets differ, so a target on the wrong projection shows.

Also, on the port alone (mirrors of ``tests/test_models_smoke.py`` and
``tests/test_models_features.py``): decode after prefill equals a prefill
over one more token, and RWKV-6's decode state has a constant size.

Tolerances: fp32 atol = rtol = 1e-4; bf16 5e-2 of the largest output
(``TOL[bfloat16]`` of ``chip_smoke.py``, the JAX SGMV tests' bf16
tolerance).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.models import model as JM
from repro.models import ssm as JS
from repro_torch import bridge
from repro_torch.models import model as TM
from repro_torch.models import ssm as TS

ATOL = 1e-4
BF16_TOL = 5e-2
ARCHS = ["zamba2-7b", "rwkv6-7b"]


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), atol=atol,
                               rtol=atol)


def _close_bf16(t, j):
    t, j = t.detach().float().numpy(), np.asarray(j, np.float32)
    scale = np.abs(j).max()
    assert np.abs(t - j).max() <= BF16_TOL * scale, (np.abs(t - j).max(),
                                                     scale)


@functools.lru_cache(maxsize=None)
def _models(arch, dtype=jnp.float32):
    """(cfg, JAX params, port params): JAX init, every leaf moved by
    0.1 x N(0, 1) from a numpy seed, then bridged."""
    cfg = get_smoke_config(arch)
    jp = JM.init_params(cfg, jax.random.PRNGKey(0))
    leaves, tree = jax.tree.flatten(jp)
    rng = np.random.default_rng(7)
    leaves = [np.asarray(x) + 0.1 * rng.standard_normal(x.shape).astype(
        np.float32) for x in leaves]
    jp = jax.tree.unflatten(tree, [jnp.asarray(x, dtype) for x in leaves])
    tdt = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}[dtype]
    tp = bridge.params_from_numpy(
        cfg, jax.tree.map(lambda x: np.asarray(x, np.float32), jp),
        device="cpu", dtype=tdt)
    return cfg, jp, tp


def _layer(jp, key, i=0):
    return jax.tree.map(lambda t: t[i], jp[key])


def _inputs(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


# ---------------------------------------------------------------------------
# Mamba2
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S", [1, 7])
def test_mamba2_full_matches_jax(S):
    cfg, jp, tp = _models("zamba2-7b")
    _, H, hd, N = JS.mamba_dims(cfg)
    u = _inputs((2, S, cfg.d_model), 0)
    s0 = _inputs((2, H, hd, N), 1) * 0.5
    jout, jst = JS.mamba2_full(cfg, _layer(jp, "mamba_blocks", 1),
                               jnp.asarray(u), jnp.asarray(s0))
    tout, tst = TS.mamba2_full(cfg, tp.mamba_blocks[1], _t(u), _t(s0))
    _close(tout, jout)
    _close(tst, jst)


def test_mamba2_step_matches_jax():
    cfg, jp, tp = _models("zamba2-7b")
    _, H, hd, N = JS.mamba_dims(cfg)
    u = _inputs((3, 1, cfg.d_model), 2)
    s0 = _inputs((3, H, hd, N), 3) * 0.5
    jout, jst = JS.mamba2_step(cfg, _layer(jp, "mamba_blocks", 2),
                               jnp.asarray(u), jnp.asarray(s0))
    tout, tst = TS.mamba2_step(cfg, tp.mamba_blocks[2], _t(u), _t(s0))
    _close(tout, jout)
    _close(tst, jst)


def test_mamba2_bf16_rounds_the_state_as_the_reference():
    """bf16 activations over an fp32 state: the state comes back in bf16
    from both forms (rounded once a sequence, and at every step), as the
    reference's does; outputs and states within the bf16 tolerance."""
    cfg, jp, tp = _models("zamba2-7b", jnp.bfloat16)
    _, H, hd, N = JS.mamba_dims(cfg)
    u = _inputs((2, 5, cfg.d_model), 4)
    s0 = _inputs((2, H, hd, N), 5) * 0.5
    bp_j, bp_t = _layer(jp, "mamba_blocks"), tp.mamba_blocks[0]
    ju = jnp.asarray(u, jnp.bfloat16)
    tu = _t(u).to(torch.bfloat16)
    jout, jst = JS.mamba2_full(cfg, bp_j, ju, jnp.asarray(s0))
    tout, tst = TS.mamba2_full(cfg, bp_t, tu, _t(s0))
    assert jst.dtype == jnp.bfloat16 and tst.dtype == torch.bfloat16
    _close_bf16(tout, jout)
    _close_bf16(tst, jst)
    jout, jst = JS.mamba2_step(cfg, bp_j, ju[:, :1], jnp.asarray(s0))
    tout, tst = TS.mamba2_step(cfg, bp_t, tu[:, :1], _t(s0))
    assert jst.dtype == jnp.bfloat16 and tst.dtype == torch.bfloat16
    _close_bf16(tout, jout)
    _close_bf16(tst, jst)


# ---------------------------------------------------------------------------
# RWKV-6
# ---------------------------------------------------------------------------


def _loras(cfg, seed):
    """A LoRA callback per framework: target t adds x @ W_t, W_t (d, d)
    from a seed, different for each of q, k, v and o."""
    rng = np.random.default_rng(seed)
    w = {t: rng.standard_normal((cfg.d_model, cfg.d_model)).astype(
        np.float32) * 0.05 for t in ("q", "k", "v", "o")}
    return (lambda name, x: x @ jnp.asarray(w[name], x.dtype),
            lambda name, x: x @ _t(w[name]).to(x.dtype))


def _rwkv_state(cfg, B, seed):
    H, hd = JS.rwkv_dims(cfg)
    return {"wkv": _inputs((B, H, hd, hd), seed) * 0.5,
            "x_tm": _inputs((B, cfg.d_model), seed + 1),
            "x_cm": _inputs((B, cfg.d_model), seed + 2)}


@pytest.mark.parametrize("S", [1, 6])
@pytest.mark.parametrize("with_lora", [False, True])
def test_rwkv6_time_mix_matches_jax(S, with_lora):
    cfg, jp, tp = _models("rwkv6-7b")
    x = _inputs((2, S, cfg.d_model), 10)
    st = _rwkv_state(cfg, 2, 11)
    jl, tl = _loras(cfg, 12) if with_lora else (None, None)
    jout, jst = JS.rwkv6_time_mix(cfg, _layer(jp, "blocks", 1),
                                  jnp.asarray(x),
                                  jax.tree.map(jnp.asarray, st), jl)
    tout, tst = TS.rwkv6_time_mix(cfg, tp.blocks[1], _t(x),
                                  {k: _t(v) for k, v in st.items()}, tl)
    _close(tout, jout)
    assert set(tst) == set(jst) == {"wkv", "x_tm"}
    for k in jst:
        _close(tst[k], jst[k])


def test_rwkv6_lora_targets_are_the_references():
    """Each target alone moves the time mix as in the reference: the q
    adapter on the receptance, k and v on their mixed inputs, o after
    the gated norm."""
    cfg, jp, tp = _models("rwkv6-7b")
    x = _inputs((2, 3, cfg.d_model), 13)
    st = _rwkv_state(cfg, 2, 14)
    jl, tl = _loras(cfg, 15)
    outs = []
    for target in ("q", "k", "v", "o"):
        jout, _ = JS.rwkv6_time_mix(
            cfg, _layer(jp, "blocks"), jnp.asarray(x),
            jax.tree.map(jnp.asarray, st),
            lambda n, y, t=target: jl(n, y) if n == t else 0.0)
        tout, _ = TS.rwkv6_time_mix(
            cfg, tp.blocks[0], _t(x), {k: _t(v) for k, v in st.items()},
            lambda n, y, t=target: tl(n, y) if n == t else 0.0)
        _close(tout, jout)
        outs.append(tout)
    for a in range(4):
        for b in range(a):
            assert not torch.allclose(outs[a], outs[b], atol=1e-3)


@pytest.mark.parametrize("S", [1, 6])
def test_rwkv6_channel_mix_matches_jax(S):
    cfg, jp, tp = _models("rwkv6-7b")
    x = _inputs((2, S, cfg.d_model), 20)
    st = _rwkv_state(cfg, 2, 21)
    jout, jst = JS.rwkv6_channel_mix(cfg, _layer(jp, "blocks"),
                                     jnp.asarray(x),
                                     jax.tree.map(jnp.asarray, st))
    tout, tst = TS.rwkv6_channel_mix(cfg, tp.blocks[0], _t(x),
                                     {k: _t(v) for k, v in st.items()})
    _close(tout, jout)
    _close(tst["x_cm"], jst["x_cm"])


def test_rwkv6_bf16_matches_jax():
    """bf16 activations: the WKV state stays fp32 in both, the time
    mix's output and state within the bf16 tolerance."""
    cfg, jp, tp = _models("rwkv6-7b", jnp.bfloat16)
    x = _inputs((2, 4, cfg.d_model), 22)
    st = _rwkv_state(cfg, 2, 23)
    jst_in = {"wkv": jnp.asarray(st["wkv"]),
              "x_tm": jnp.asarray(st["x_tm"], jnp.bfloat16)}
    tst_in = {"wkv": _t(st["wkv"]),
              "x_tm": _t(st["x_tm"]).to(torch.bfloat16)}
    jl, tl = _loras(cfg, 24)
    jout, jst = JS.rwkv6_time_mix(cfg, _layer(jp, "blocks"),
                                  jnp.asarray(x, jnp.bfloat16), jst_in, jl)
    tout, tst = TS.rwkv6_time_mix(cfg, tp.blocks[0],
                                  _t(x).to(torch.bfloat16), tst_in, tl)
    assert jst["wkv"].dtype == jnp.float32 and tst["wkv"].dtype == \
        torch.float32
    assert tout.dtype == torch.bfloat16
    _close_bf16(tout, jout)
    _close_bf16(tst["wkv"], jst["wkv"])


# ---------------------------------------------------------------------------
# the models on the port alone
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_consistency(arch):
    """Decode after prefill matches a prefill over one more token (the
    port's teacher-forced pass), as ``test_models_smoke`` holds the JAX
    model's decode against its forward."""
    cfg = get_smoke_config(arch)
    params = TM.init_params(cfg, 2, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 11)).astype(np.int32))
    full, _ = TM.prefill(cfg, params, tokens)
    _, cache = TM.prefill(cfg, params, tokens[:, :10], cache_len=14)
    dec, _ = TM.decode_step(cfg, params, cache, tokens[:, 10])
    rel = (full - dec).abs().max().item() / (full.abs().max().item() + 1e-9)
    assert rel < 1e-3, f"{arch}: decode/prefill mismatch {rel}"


def test_rwkv_decode_state_is_constant_size():
    cfg = get_smoke_config("rwkv6-7b")
    params = TM.init_params(cfg, 4, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (1, 6)).astype(np.int32))
    _, cache = TM.prefill(cfg, params, toks, cache_len=6)
    assert "k" not in cache        # no KV cache at all
    sizes = {k: v.numel() for k, v in cache.items()}
    _, cache2 = TM.decode_step(cfg, params, cache,
                               torch.zeros(1, dtype=torch.int32))
    assert {k: v.numel() for k, v in cache2.items()} == sizes


def test_rwkv_bf16_decode_over_an_fp32_cache():
    """bf16 weights over the engine's fp32 cache (ROADMAP C12): the JAX
    decode refuses it (its layer scan gets an fp32 residual back for a
    bf16 one); the port takes the token shifts in the activation type,
    which gives bit for bit the logits of a bf16 cache, and those lie
    within the bf16 tolerance of the JAX decode over a bf16 cache."""
    cfg, jp, tp = _models("rwkv6-7b", jnp.bfloat16)
    toks = np.array([[5, 9, 2, 7, 1], [8, 8, 4, 6, 2]], np.int32)
    nxt = np.array([3, 11], np.int32)
    _, jc32 = JM.prefill(cfg, jp, jnp.asarray(toks), cache_len=8,
                         cache_dtype=jnp.float32)
    with pytest.raises(TypeError):
        JM.decode_step(cfg, jp, jc32, jnp.asarray(nxt))
    _, jc16 = JM.prefill(cfg, jp, jnp.asarray(toks), cache_len=8,
                         cache_dtype=jnp.bfloat16)
    jd, _ = JM.decode_step(cfg, jp, jc16, jnp.asarray(nxt))
    logits = []
    for dtype in (torch.float32, torch.bfloat16):
        _, c = TM.prefill(cfg, tp, _t(toks), cache_len=8, cache_dtype=dtype)
        assert c["wkv"].dtype == torch.float32
        d, _ = TM.decode_step(cfg, tp, c, _t(nxt))
        logits.append(d)
    assert torch.equal(logits[0], logits[1])
    _close_bf16(logits[0], jd)
