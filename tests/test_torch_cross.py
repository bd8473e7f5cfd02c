"""PyTorch port, cross-attention and the non-causal routes of kernel B5,
held against the JAX package (``models/attention.py``: ``init_cross_attn``,
``cross_kv``, ``cross_attend``, ``gqa_full(causal=False)``; its
``models/common.flash_attention(causal=False)``), weights made in JAX
and copied across through numpy:

* ``cross_kv`` and ``cross_attend`` at S = 1 (``attend_cache`` over every
  key) and at S > 1, MHA (the port's B5 route, on the CPU
  ``flash_mha_plain(causal=False)``) and GQA (``flash_attention``);
* ``gqa_full(causal=False)`` from position 0 on the B5 route (Sq = Sk),
  and ``flash_mha_plain(causal=False)`` against ``flash_attention``
  directly at Sq = Sk and Sq != Sk;
* which calls take B5: MHA non-causal from position 0 and MHA
  cross-attention at S > 1; GQA, windows, explicit positions and S = 1
  do not;
* the types of JAX's promotion: bf16 queries over fp32 cross K/V give a
  bf16 output, an fp32 memory over bf16 weights fp32 K/V.

Tolerances: fp32 atol = rtol = 1e-4 (the two frameworks sum in different
orders); bf16 5e-2 of the largest output (``TOL[bfloat16]`` of
``chip_smoke.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.models import attention as JA
from repro.models import common as JC
from repro_torch.kernels import flash as tflash
from repro_torch.models import attention as TA

ATOL = 1e-4
BF16_TOL = 5e-2


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), atol=atol,
                               rtol=atol)


def _cfg(n_kv):
    """seamless-m4t-large-v2-smoke (d 128, 4 heads of 32) with ``n_kv``
    kv heads: 4 is its MHA, 2 a GQA form."""
    return dataclasses.replace(get_smoke_config("seamless-m4t-large-v2"),
                               n_kv_heads=n_kv)


def _copy(module, tree):
    with torch.no_grad():
        for name, p in module.named_parameters():
            p.copy_(_t(tree[name]).to(p.dtype))
    return module


def _cross(n_kv, seed=0):
    cfg = _cfg(n_kv)
    jp = JA.init_cross_attn(cfg, jax.random.PRNGKey(seed))
    tp = _copy(TA.CrossAttention(cfg, torch.Generator().manual_seed(0)), jp)
    assert [n for n, _ in tp.named_parameters()] == ["wq", "wk", "wv", "wo"]
    return cfg, jp, tp


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


class _B5Calls:
    """Counts the calls of B5 made through ``models.attention``, with
    their ``causal`` and (Sq, Sk)."""

    def __init__(self, monkeypatch):
        self.calls = []
        orig = TA.flash_mha

        def call(q, k, v, *, causal=True, **kw):
            self.calls.append((causal, q.shape[2], k.shape[2]))
            return orig(q, k, v, causal=causal, **kw)
        monkeypatch.setattr(TA, "flash_mha", call)


@pytest.mark.parametrize("n_kv", [4, 2])
def test_cross_kv_matches_jax(n_kv):
    cfg, jp, tp = _cross(n_kv)
    mem = _rand((2, 16, cfg.d_model), 1)
    kj, vj = JA.cross_kv(cfg, jp, jnp.asarray(mem))
    kt, vt = TA.cross_kv(cfg, tp, _t(mem))
    assert kt.shape == (2, 16, n_kv, cfg.resolved_head_dim)
    _close(kt, kj)
    _close(vt, vj)


@pytest.mark.parametrize("S", [1, 5, 16, 23])
@pytest.mark.parametrize("n_kv", [4, 2])
def test_cross_attend_matches_jax(monkeypatch, n_kv, S):
    """S = 1 is decode (``attend_cache``), S > 1 prefill: Sq below, at
    and above Sk = 16. MHA at S > 1 takes B5, non-causal."""
    cfg, jp, tp = _cross(n_kv)
    b5 = _B5Calls(monkeypatch)
    x = _rand((2, S, cfg.d_model), 2)
    mem = _rand((2, 16, cfg.d_model), 3)
    k, v = JA.cross_kv(cfg, jp, jnp.asarray(mem))
    oj = JA.cross_attend(cfg, jp, jnp.asarray(x), k, v)
    ot = TA.cross_attend(cfg, tp, _t(x), _t(k), _t(v))
    assert ot.shape == (2, S, cfg.d_model)
    _close(ot, oj)
    mha_prefill = n_kv == cfg.n_heads and S > 1
    assert b5.calls == ([(False, S, 16)] if mha_prefill else [])


@pytest.mark.parametrize("S", [1, 9])
def test_cross_attend_takes_a_lora_hook(S):
    """The optional hook is added to the q and o projections (no caller
    of the reference passes one, ROADMAP C3)."""
    cfg, jp, tp = _cross(4)
    x = _rand((2, S, cfg.d_model), 4)
    mem = _rand((2, 16, cfg.d_model), 5)
    k, v = JA.cross_kv(cfg, jp, jnp.asarray(mem))
    seen = []

    def jhook(name, h):
        return 0.1 * jnp.sin(h[..., :cfg.d_model])

    def thook(name, h):
        seen.append(name)
        return 0.1 * torch.sin(h[..., :cfg.d_model])
    oj = JA.cross_attend(cfg, jp, jnp.asarray(x), k, v, lora=jhook)
    ot = TA.cross_attend(cfg, tp, _t(x), _t(k), _t(v), lora=thook)
    _close(ot, oj)
    assert seen == ["q", "o"]


@pytest.mark.parametrize("causal", [False, True])
def test_gqa_full_non_causal_on_b5_matches_jax(monkeypatch, causal):
    """The audio encoder's self-attention: RoPE over the frame positions,
    bidirectional, MHA from position 0 -> B5 with Sq = Sk."""
    cfg = _cfg(4)
    jp = JA.init_gqa(cfg, jax.random.PRNGKey(7))
    tp = _copy(TA.GQAAttention(cfg, torch.Generator().manual_seed(0)), jp)
    b5 = _B5Calls(monkeypatch)
    x = _rand((2, 16, cfg.d_model), 8)
    pos = np.arange(16, dtype=np.int32)
    oj, (kj, vj) = JA.gqa_full(cfg, jp, jnp.asarray(x), jnp.asarray(pos),
                               causal=causal)
    ot, (kt, vt) = TA.gqa_full(cfg, tp, _t(x), causal=causal)
    _close(ot, oj)
    _close(kt, kj)
    _close(vt, vj)
    assert b5.calls == [(causal, 16, 16)]


@pytest.mark.parametrize("route", ["gqa", "window", "positions"])
def test_other_full_attention_stays_off_b5(monkeypatch, route):
    """GQA, a sliding window and explicit positions run on
    ``flash_attention``, causal or not, and still match JAX."""
    cfg = _cfg(2 if route == "gqa" else 4)
    jp = JA.init_gqa(cfg, jax.random.PRNGKey(9))
    tp = _copy(TA.GQAAttention(cfg, torch.Generator().manual_seed(0)), jp)
    b5 = _B5Calls(monkeypatch)
    x = _rand((2, 12, cfg.d_model), 10)
    pos = np.arange(12, dtype=np.int32)
    window = 4 if route == "window" else 0
    oj, _ = JA.gqa_full(cfg, jp, jnp.asarray(x), jnp.asarray(pos),
                        causal=False, window=window)
    ot, _ = TA.gqa_full(cfg, tp, _t(x),
                        _t(pos) if route == "positions" else None,
                        causal=False, window=window)
    _close(ot, oj)
    assert b5.calls == []


@pytest.mark.parametrize("Sq,Sk", [(16, 16), (7, 16), (40, 24), (1, 9)])
def test_flash_mha_plain_non_causal_matches_flash_attention(Sq, Sk):
    """B5's plain version, non-causal, against the reference's
    ``flash_attention(causal=False)`` over ``arange(Sq)`` and
    ``arange(Sk)``, which masks nothing but the padding."""
    q = _rand((2, Sq, 3, 32), 11)
    k = _rand((2, Sk, 3, 32), 12)
    v = _rand((2, Sk, 3, 32), 13)
    oj = JC.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal=False, q_positions=jnp.arange(Sq),
                            k_positions=jnp.arange(Sk), chunk_q=8,
                            chunk_k=8)
    ot = tflash.flash_mha_plain(_t(q).transpose(1, 2), _t(k).transpose(1, 2),
                                _t(v).transpose(1, 2), causal=False)
    _close(ot.transpose(1, 2), oj)


def test_promoted_types_match_jax():
    """bf16 weights: an fp32 memory gives fp32 K/V; bf16 queries over
    them give a bf16 output, at S = 1 and on the B5 route at S > 1, each
    within the bf16 tolerance of JAX's."""
    cfg, jp32, _ = _cross(4)
    jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp32)
    tp = _copy(TA.CrossAttention(cfg, torch.Generator().manual_seed(0),
                                 dtype=torch.bfloat16),
               jax.tree.map(lambda a: np.asarray(a, np.float32), jp))
    mem = _rand((2, 16, cfg.d_model), 14, 0.5)
    kj, vj = JA.cross_kv(cfg, jp, jnp.asarray(mem))
    kt, vt = TA.cross_kv(cfg, tp, _t(mem))
    assert kj.dtype == jnp.float32 and kt.dtype == torch.float32
    _close(kt, kj)
    for S in (1, 10):
        x = _rand((2, S, cfg.d_model), 15)
        xj = jnp.asarray(x).astype(jnp.bfloat16)
        oj = JA.cross_attend(cfg, jp, xj, kj, vj)
        ot = TA.cross_attend(cfg, tp,
                             _t(np.asarray(xj, np.float32)).bfloat16(), kt,
                             vt)
        assert oj.dtype == jnp.bfloat16 and ot.dtype == torch.bfloat16
        oj = np.asarray(oj, np.float32)
        err = np.abs(ot.float().numpy() - oj).max()
        assert err <= BF16_TOL * np.abs(oj).max(), (S, err)
