"""PyTorch port, model layer: norms, rope, attention, and the dense
model's prefill / decode logits held against the JAX package at
llama-7b-paper-smoke, with params and nonzero-B LoRA banks made in JAX
and bridged through numpy.

Tolerances: fp32 atol = 1e-4 on logits and activations (two frameworks
sum in different orders); bf16 is not compared across frameworks.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.lora.bank import build_bank as jax_build_bank
from repro.models import attention as JA
from repro.models import common as JC
from repro.models import model as JM
from repro_torch import bridge
from repro_torch.lora.bank import build_bank
from repro_torch.models import attention as TA
from repro_torch.models import common as TC
from repro_torch.models import model as TM

ADAPTERS = {"a-r8": 8, "b-r64": 64, "c-r8": 8}
ATOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), atol=atol,
                               rtol=atol)


# ---------------------------------------------------------------------------
# common.py
# ---------------------------------------------------------------------------


def test_rmsnorm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    s = rng.standard_normal(64).astype(np.float32)
    _close(TC.rmsnorm(_t(x), _t(s)), JC.rmsnorm(jnp.asarray(x),
                                               jnp.asarray(s)))


@pytest.mark.parametrize("decode", [False, True])
def test_apply_rope_matches_jax(decode):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 1 if decode else 9, 4, 32)).astype(
        np.float32)
    pos = np.array([[3], [700]], np.int32) if decode else \
        np.arange(9, dtype=np.int32)
    _close(TC.apply_rope(_t(x), _t(pos), 1e4),
           JC.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4))


@pytest.mark.parametrize("H,Kv,window,causal,chunk", [
    (4, 4, 0, True, 1024),     # MHA causal
    (8, 2, 0, True, 4),        # GQA, several kv chunks
    (4, 4, 3, True, 1024),     # sliding window
    (6, 3, 0, False, 5),       # non-causal, ragged last chunk
])
def test_flash_attention_matches_jax(H, Kv, window, causal, chunk):
    rng = np.random.default_rng(H * 10 + Kv)
    B, S, hd = 2, 11, 16
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, Kv, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, Kv, hd)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)
    kw = dict(causal=causal, window=window, chunk_q=chunk, chunk_k=chunk)
    _close(TC.flash_attention(_t(q), _t(k), _t(v), q_positions=_t(pos),
                              k_positions=_t(pos), **kw),
           JC.flash_attention(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), q_positions=jnp.asarray(pos),
                              k_positions=jnp.asarray(pos), **kw))


def test_attend_cache_matches_jax():
    rng = np.random.default_rng(2)
    B, S, H, Kv, hd = 3, 10, 8, 2, 16
    q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    kc = rng.standard_normal((B, S, Kv, hd)).astype(np.float32)
    vc = rng.standard_normal((B, S, Kv, hd)).astype(np.float32)
    valid = np.arange(S)[None, :] <= np.array([[2], [9], [0]])
    _close(TC.attend_cache(_t(q), _t(kc), _t(vc), _t(valid)),
           JC.attend_cache(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                           jnp.asarray(valid)))


# ---------------------------------------------------------------------------
# attention.py / model.py
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def setup():
    cfg = get_smoke_config("llama-7b-paper")
    jp = JM.init_params(cfg, jax.random.PRNGKey(0))
    tp = bridge.params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                                  device="cpu")
    return cfg, jp, tp


def _gqa_setup(cfg, seed, n_kv):
    cfg = dataclasses.replace(cfg, n_kv_heads=n_kv)
    jp = JA.init_gqa(cfg, jax.random.PRNGKey(seed))
    tp = TA.GQAAttention(cfg, torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for name, p in tp.named_parameters():
            p.copy_(_t(jp[name]))
    return cfg, jp, tp


@pytest.mark.parametrize("n_kv", [4, 2])
def test_gqa_full_matches_jax(setup, n_kv):
    cfg, jp, tp = _gqa_setup(setup[0], 3, n_kv)
    x = np.random.default_rng(3).standard_normal((2, 7, 128)).astype(
        np.float32)
    pos = np.arange(7, dtype=np.int32)
    oj, (kj, vj) = JA.gqa_full(cfg, jp, jnp.asarray(x), jnp.asarray(pos))
    ot, (kt, vt) = TA.gqa_full(cfg, tp, _t(x), _t(pos))
    _close(ot, oj)
    _close(kt, kj)
    _close(vt, vj)


@pytest.mark.parametrize("window", [0, 4])
def test_gqa_decode_matches_jax_including_rows_past_the_cache(setup,
                                                              window):
    """Rows whose position ran past the cache (free slots, frozen rows)
    must drop their write as JAX does, never land on a real slot."""
    cfg, jp, tp = _gqa_setup(setup[0], 4, 2)
    rng = np.random.default_rng(4)
    B, S = 3, 6
    x = rng.standard_normal((B, 1, 128)).astype(np.float32)
    kc = rng.standard_normal((B, S, 2, 32)).astype(np.float32)
    vc = rng.standard_normal((B, S, 2, 32)).astype(np.float32)
    pos = np.array([2, S, S + 5], np.int32)
    oj, (kj, vj) = JA.gqa_decode(cfg, jp, jnp.asarray(x), jnp.asarray(kc),
                                 jnp.asarray(vc), jnp.asarray(pos),
                                 window=window)
    ot, (kt, vt) = TA.gqa_decode(cfg, tp, _t(x), _t(kc), _t(vc), _t(pos),
                                 window=window)
    _close(ot, oj)
    _close(kt, kj)
    _close(vt, vj)
    if not window:      # rows past the cache left their slots untouched
        np.testing.assert_array_equal(kt[1:].numpy(), kc[1:])


def _nonzero_weights(cfg, ranks, seed):
    rng = np.random.default_rng(seed)
    L, d = cfg.n_layers, cfg.d_model
    return {aid: {t: {"A": (rng.standard_normal((L, d, r)) * 0.2
                            ).astype(np.float32),
                      "B": (rng.standard_normal((L, r, d)) * 0.2
                            ).astype(np.float32)}
                  for t in cfg.lora.targets}
            for aid, r in ranks.items()}


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


@pytest.fixture(scope="module")
def jax_runs(setup):
    """JAX prefill + one decode step per bank mode (gather-einsum: the
    JAX suite proves einsum == sgmv on its side)."""
    cfg, jp, _ = setup
    weights = _nonzero_weights(cfg, ADAPTERS, 5)
    toks = np.array([[5, 9, 2, 7, 1, 3], [8, 8, 4, 6, 2, 11],
                     [3, 1, 4, 1, 5, 9]], np.int32)
    gi = np.array([0, 1, 2], np.int32)
    out = {}
    for mode in ("padded", "bucketed"):
        jb = _jax_bank(cfg, mode, weights)
        idx = jb.lora_idx(jnp.asarray(gi))
        lp, cache = JM.prefill(cfg, jp, jnp.asarray(toks), bank=jb.data,
                               lora_idx=idx, cache_len=10,
                               cache_dtype=jnp.float32)
        nxt = np.asarray(jnp.argmax(lp, axis=-1)).astype(np.int32)
        ld, cache2 = JM.decode_step(cfg, jp, cache, jnp.asarray(nxt),
                                    bank=jb.data, lora_idx=idx)
        out[mode] = (jb, np.asarray(lp), nxt, np.asarray(ld),
                     np.asarray(cache2["k"]))
    return toks, gi, out


@pytest.mark.parametrize("mode", ["padded", "bucketed"])
@pytest.mark.parametrize("kernel", ["einsum", "sgmv"])
def test_prefill_decode_logits_match_jax(setup, jax_runs, mode, kernel):
    cfg, _, tp = setup
    toks, gi, out = jax_runs
    jb, lp, nxt, ld, k2 = out[mode]
    tb = _bridge_bank(cfg, jb)
    idx = tb.lora_idx(_t(gi))
    lt, cache = TM.prefill(cfg, tp, _t(toks), bank=tb.data, lora_idx=idx,
                           cache_len=10, cache_dtype=torch.float32,
                           lora_kernel=kernel)
    _close(lt, lp)
    np.testing.assert_array_equal(lt.argmax(-1).numpy(), nxt)
    ldt, cache2 = TM.decode_step(cfg, tp, cache, _t(nxt), bank=tb.data,
                                 lora_idx=idx, lora_kernel=kernel)
    _close(ldt, ld)
    _close(cache2["k"], k2)
    assert cache2["pos"].tolist() == [toks.shape[1] + 1] * 3


def test_lora_delta_is_live(setup, jax_runs):
    """The bridged nonzero-B bank moves the logits: a broken delta would
    not pass the parity test above silently."""
    cfg, _, tp = setup
    toks, _, out = jax_runs
    lt, _ = TM.prefill(cfg, tp, _t(toks), cache_len=10)
    assert np.abs(lt.numpy() - out["padded"][1]).max() > 1e-2


@pytest.mark.parametrize("kernel", ["einsum", "sgmv"])
def test_model_logits_allclose_across_modes(setup, kernel):
    """The port's own padded and bucketed banks (nonzero weights written
    into both) give the same logits, prefill and decode."""
    cfg, _, tp = setup
    weights = _nonzero_weights(cfg, ADAPTERS, 6)
    banks = {}
    for mode in ("padded", "bucketed"):
        bank = build_bank(cfg, ADAPTERS, 1, mode=mode, device="cpu")
        for aid, w in weights.items():
            bank.set_adapter(aid, bridge.adapter_weights_from_numpy(w))
        banks[mode] = bank
    toks = torch.arange(1, 7)[None, :].repeat(3, 1)
    gi = torch.tensor([0, 1, 2], dtype=torch.int32)
    res = {}
    for mode, bank in banks.items():
        idx = bank.lora_idx(gi)
        lp, cache = TM.prefill(cfg, tp, toks, bank=bank.data, lora_idx=idx,
                               cache_len=16, lora_kernel=kernel)
        ld, _ = TM.decode_step(cfg, tp, cache, lp.argmax(-1), bank=bank.data,
                               lora_idx=idx, lora_kernel=kernel)
        res[mode] = (lp, ld)
    for a, b in zip(res["padded"], res["bucketed"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)


@pytest.mark.parametrize("mode", ["padded", "bucketed"])
def test_lora_cb_sgmv_kernel_matches_einsum(setup, mode):
    cfg, _, tp = setup
    bank = build_bank(cfg, ADAPTERS, 1, mode=mode, device="cpu")
    for aid, w in _nonzero_weights(cfg, ADAPTERS, 7).items():
        bank.set_adapter(aid, bridge.adapter_weights_from_numpy(w))
    toks = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]])
    idx = bank.lora_idx(torch.tensor([0, 1], dtype=torch.int32))
    le, ce = TM.prefill(cfg, tp, toks, bank=bank.data, lora_idx=idx,
                        cache_len=8)
    lk, ck = TM.prefill(cfg, tp, toks, bank=bank.data, lora_idx=idx,
                        cache_len=8, lora_kernel="sgmv")
    np.testing.assert_allclose(le.numpy(), lk.numpy(), atol=1e-5)
    nxt = le.argmax(-1)
    l2e, _ = TM.decode_step(cfg, tp, ce, nxt, bank=bank.data, lora_idx=idx)
    l2k, _ = TM.decode_step(cfg, tp, ck, nxt, bank=bank.data, lora_idx=idx,
                            lora_kernel="sgmv")
    np.testing.assert_allclose(l2e.numpy(), l2k.numpy(), atol=1e-5)


def test_bank_layouts_match_jax(setup):
    """Bank descriptors: layout, signature, lora_idx and nbytes agree with
    the JAX package (mirrors test_bank_modes build/idx tests)."""
    cfg = setup[0]
    for mode in ("padded", "bucketed"):
        jb = jax_build_bank(cfg, ADAPTERS, jax.random.PRNGKey(1), mode=mode)
        tb = build_bank(cfg, ADAPTERS, 1, mode=mode, device="cpu")
        assert tb.adapter_ids == jb.adapter_ids
        assert tb.signature == jb.signature
        assert tb.nbytes() == jb.nbytes()
        gi = np.array([0, 1, 2], np.int32)
        np.testing.assert_array_equal(tb.lora_idx(_t(gi)).numpy(),
                                      np.asarray(jb.lora_idx(gi)))
        tree, row, r = tb._rows("b-r64")
        assert row == jb._rows("b-r64")[1] and r == 64
        w = tb.get_adapter("a-r8")
        assert w["q"]["A"].shape == (cfg.n_layers, cfg.d_model, 8)
        assert not w["q"]["B"].any()                 # B = 0 at init


def test_other_families_raise(setup):
    cfg = dataclasses.replace(setup[0], family="hybrid")
    with pytest.raises(NotImplementedError, match="item 10"):
        TM.init_params(cfg, 0, device="cpu")
