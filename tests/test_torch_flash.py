"""PyTorch port, flash-attention kernel B5: the plain version of
``repro_torch.kernels.flash.flash_mha`` held against the JAX package's
Pallas ``flash_mha`` (interpret mode) and its model-zoo
``flash_attention``, and the prefill route through B5 held against the
JAX model on the same numpy inputs.

Tolerances, the JAX suite's own (test_kernels_flash.py:29, :51): fp32
2e-5 against the Pallas kernel, bf16 3e-2; 1e-4 against the chunked
``flash_attention`` and on logits (two frameworks, other sum orders).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.kernels.flash import flash_mha as jax_flash_mha
from repro.models import attention as JA
from repro.models import common as JC
from repro.models import model as JM
from repro_torch import bridge
from repro_torch.kernels import flash as tflash
from repro_torch.models import attention as TA
from repro_torch.models import model as TM

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _qkv(shape_q, shape_k, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape_q).astype(np.float32),
            rng.standard_normal(shape_k).astype(np.float32),
            rng.standard_normal(shape_k).astype(np.float32))


def _np(y):
    if isinstance(y, torch.Tensor):
        return y.float().numpy()
    return np.asarray(y.astype(jnp.float32))


@pytest.mark.parametrize("B,H,Sq,Sk,hd,bq,bk", [   # test_kernels_flash:11
    (1, 2, 64, 64, 32, 32, 32),
    (2, 4, 100, 100, 64, 32, 64),      # ragged sequence vs block, bq != bk
    (1, 1, 128, 256, 32, 64, 64),      # cross-length (kv longer)
    (2, 2, 33, 33, 16, 16, 16),
])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_flash_mha(B, H, Sq, Sk, hd, bq, bk, causal,
                                        dtype):
    """Causal Sq != Sk is compared with the Pallas kernel itself, whose
    mask is top-left aligned like the port's (not with the JAX oracle)."""
    q, k, v = _qkv((B, H, Sq, hd), (B, H, Sk, hd), B * 100 + Sq + causal)
    qj, kj, vj = (jnp.asarray(a).astype(JDT[dtype]) for a in (q, k, v))
    qt, kt, vt = (torch.from_numpy(a).to(TDT[dtype]) for a in (q, k, v))
    oj = jax_flash_mha(qj, kj, vj, causal=causal, block_q=bq, block_k=bk,
                       interpret=True)
    ot = tflash.flash_mha(qt, kt, vt, causal=causal, block_q=bq,
                          block_k=bk)
    assert ot.dtype == TDT[dtype] and ot.shape == (B, H, Sq, hd)
    np.testing.assert_allclose(_np(ot), _np(oj), atol=TOL[dtype],
                               rtol=TOL[dtype])


def test_plain_matches_model_flash_attention():
    """As test_kernels_flash.py:36: the kernel's function equals the
    chunked attention the JAX prefill runs, on the (B, S, H, hd) layout
    read through a transpose."""
    B, S, H, hd = 2, 96, 4, 32
    q, k, v = _qkv((B, S, H, hd), (B, S, H, hd), 7)
    pos = jnp.arange(S)
    oj = JC.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal=True, q_positions=pos, k_positions=pos,
                            chunk_q=32, chunk_k=32)
    qt, kt, vt = (torch.from_numpy(a).transpose(1, 2) for a in (q, k, v))
    ot = tflash.flash_mha(qt, kt, vt, causal=True, block_q=32, block_k=32)
    np.testing.assert_allclose(ot.transpose(1, 2).numpy(), np.asarray(oj),
                               atol=1e-4, rtol=1e-4)


def test_causal_first_token_attends_self_only():
    """As test_kernels_flash.py:56: row 0 sees key 0 alone, so its output
    is v[0]."""
    q, k, v = _qkv((1, 1, 32, 16), (1, 1, 32, 16), 0)
    ot = tflash.flash_mha(*(torch.from_numpy(a) for a in (q, k, v)),
                          causal=True, block_q=16, block_k=16)
    np.testing.assert_allclose(ot[0, 0, 0].numpy(), v[0, 0, 0], atol=1e-5)


def test_wrapper_on_cpu_uses_plain_version_and_counts_nothing():
    q, k, v = (torch.from_numpy(a) for a in
               _qkv((2, 3, 20, 16), (2, 3, 20, 16), 1))
    n = tflash.flash_mha.launches
    o = tflash.flash_mha(q, k, v, causal=True)
    assert torch.equal(o, tflash.flash_mha_plain(q, k, v, causal=True))
    assert tflash.flash_mha.launches == n


def test_wrapper_refuses_non_cuda_devices():
    q = torch.empty((1, 2, 8, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tflash.flash_mha(q, q, q)


# ---------------------------------------------------------------------------
# the prefill route through B5
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def smoke():
    cfg = get_smoke_config("llama-7b-paper")
    jp = JM.init_params(cfg, jax.random.PRNGKey(0))
    tp = bridge.params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                                  device="cpu")
    return cfg, jp, tp


class _Spy:
    """Stands in for ``attention.flash_mha`` and counts the calls."""

    def __init__(self, monkeypatch):
        self.calls = 0
        monkeypatch.setattr(TA, "flash_mha", self)

    def __call__(self, *a, **kw):
        self.calls += 1
        return tflash.flash_mha(*a, **kw)


def _gqa(cfg, seed, n_kv):
    cfg = dataclasses.replace(cfg, n_kv_heads=n_kv)
    jp = JA.init_gqa(cfg, jax.random.PRNGKey(seed))
    tp = TA.GQAAttention(cfg, torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for name, p in tp.named_parameters():
            p.copy_(torch.from_numpy(np.array(jp[name])))
    return cfg, jp, tp


@pytest.mark.parametrize("n_kv,window,explicit,routed", [
    (4, 0, False, True),       # MHA prefill: B5
    (4, 0, True, False),       # positions given: flash_attention
    (4, 3, False, False),      # sliding window: flash_attention
    (2, 0, False, False),      # GQA: flash_attention
])
def test_gqa_full_routes_prefill_to_flash_mha(smoke, monkeypatch, n_kv,
                                              window, explicit, routed):
    cfg, jp, tp = _gqa(smoke[0], 3, n_kv)
    spy = _Spy(monkeypatch)
    x = np.random.default_rng(3).standard_normal((2, 9, 128)).astype(
        np.float32)
    pos = np.arange(9, dtype=np.int32)
    oj, (kj, _) = JA.gqa_full(cfg, jp, jnp.asarray(x), jnp.asarray(pos),
                              window=window)
    ot, (kt, _) = TA.gqa_full(cfg, tp, torch.from_numpy(x),
                              torch.from_numpy(pos) if explicit else None,
                              window=window)
    assert spy.calls == int(routed)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(kt.numpy(), np.asarray(kj), atol=1e-4,
                               rtol=1e-4)


def test_prefill_logits_match_jax_through_flash_mha(smoke, monkeypatch):
    """The smoke-size prefill takes B5 in every layer and its logits and
    cache agree with the JAX prefill, which runs flash_attention."""
    cfg, jp, tp = smoke
    spy = _Spy(monkeypatch)
    toks = np.random.default_rng(4).integers(
        1, cfg.vocab_size, (3, 40)).astype(np.int32)
    lj, cj = JM.prefill(cfg, jp, jnp.asarray(toks), cache_len=44,
                        cache_dtype=jnp.float32)
    lt, ct = TM.prefill(cfg, tp, torch.from_numpy(toks), cache_len=44,
                        cache_dtype=torch.float32)
    assert spy.calls == cfg.n_layers
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(ct["v"].numpy(), np.asarray(cj["v"]),
                               atol=1e-4, rtol=1e-4)
