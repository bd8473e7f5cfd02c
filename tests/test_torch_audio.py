"""PyTorch port, the audio encoder-decoder family served: seamless-m4t-
large-v2 at its smoke config, with params, a nonzero-B LoRA bank and a
nonzero frontend (N(0, 0.02^2) frames) made in numpy and JAX and bridged:

* the bidirectional encoder (``_run_audio_encoder``) against JAX; a zero
  frontend gives an exactly zero memory and zero cross K/V (why the
  engine's tokens cannot see the encoder);
* prefill and decode logits and every cache entry (``k``/``v``,
  ``xk``/``xv``) against JAX in both bank layouts, on the SGMV path
  (the port's plain versions; the JAX side's Pallas kernels in interpret
  mode) and on einsum;
* bf16 weights under an fp32 frontend: JAX promotes, so the memory and
  the cross K/V are fp32 and the decoder's hidden state bf16; the port
  gives the same types and logits within the bf16 tolerance;
* LoRA reaches the decoder's self-attention in prefill only (ROADMAP
  C3): decode with the bank equals decode without it, bit for bit;
* prefill + one decode step against the prefill of one more token;
* padded == bucketed bit for bit;
* the engine's tokens against the JAX engine's, padded and bucketed,
  decode blocks 1 and 4;
* the calls that would launch: B1/B2 4 x n_layers per prefill group, B5
  n_layers causal + encoder layers + n_layers cross per group, nothing
  per decode step.

Tolerances: fp32 atol = rtol = 1e-4; bf16 5e-2 of the largest logit;
tokens and bits exact.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_cross_families as X
from repro.models import model as JM
from repro_torch.models import model as TM

ARCH = "seamless-m4t-large-v2"


@functools.lru_cache(maxsize=None)
def _jax_run(mode):
    cfg, jp, _, weights, fe = X.setup(ARCH)
    return X.jax_run(cfg, jp, X.banks(cfg, weights, mode)[0], fe)


@functools.lru_cache(maxsize=None)
def _jax_tokens():
    cfg, jp, _, weights, _ = X.setup(ARCH)
    return X.serve(cfg, jp, weights, jax_side=True)[0]


def test_encoder_matches_jax():
    cfg, jp, tp, _, fe = X.setup(ARCH)
    mj = JM._run_audio_encoder(cfg, jp, jnp.asarray(fe))
    mt = TM._run_audio_encoder(cfg, tp, X.t_(fe))
    assert mt.shape == (len(fe), cfg.encoder.n_frames, cfg.d_model)
    X.close(mt, mj)
    assert mt.abs().max() > 0.1


def test_zero_frontend_gives_zero_memory_and_cross_kv():
    """rmsnorm(0) = 0 and every layer adds 0: the engine's zero frontend
    leaves the memory, ``xk`` and ``xv`` exactly 0 in both packages."""
    cfg, jp, tp, _, fe = X.setup(ARCH)
    zeros = np.zeros_like(fe)
    assert not np.asarray(JM._run_audio_encoder(cfg, jp,
                                                jnp.asarray(zeros))).any()
    assert not TM._run_audio_encoder(cfg, tp, X.t_(zeros)).any()
    _, cache = TM.prefill(cfg, tp, X.t_(X.TOKS), frontend=X.t_(zeros))
    assert not cache["xk"].any() and not cache["xv"].any()


@pytest.mark.parametrize("mode,kernel", [("padded", "sgmv"),
                                         ("bucketed", "sgmv"),
                                         ("padded", "einsum")])
def test_prefill_decode_logits_and_caches_match_jax(mode, kernel):
    cfg, _, tp, weights, fe = X.setup(ARCH)
    tb = X.banks(cfg, weights, mode)[1]
    X.check_run(X.port_run(cfg, tp, tb, fe, kernel), _jax_run(mode))


def test_frontend_and_adapters_move_the_logits():
    cfg, _, tp, weights, fe = X.setup(ARCH)
    tb = X.banks(cfg, weights, "padded")[1]
    lt = X.port_run(cfg, tp, tb, fe)[0]
    zero = X.port_run(cfg, tp, tb, np.zeros_like(fe))[0]
    plain = X.port_run(cfg, tp, None, fe)[0]
    assert (lt - zero).abs().max() > 0.1
    assert (lt - plain).abs().max() > 0.1


def test_bf16_weights_under_an_fp32_frontend_match_jax():
    cfg, jb, tb, _, fe = X.bf16_setup(ARCH)
    mj = JM._run_audio_encoder(cfg, jb, jnp.asarray(fe))
    mt = TM._run_audio_encoder(cfg, tb, X.t_(fe))
    assert mj.dtype == jnp.float32 and mt.dtype == torch.float32
    X.close_bf16(mt, mj)
    lj, dj, cj = X.jax_run(cfg, jb, None, fe, cache_dtype=jnp.bfloat16)
    lt, dt, ct = X.port_run(cfg, tb, None, fe, cache_dtype=torch.bfloat16,
                            nxt=lj)
    X.close_bf16(lt, lj)
    X.close_bf16(dt, dj)
    for key in ("k", "v", "xk", "xv"):
        assert ct[key].dtype == torch.bfloat16
        X.close_bf16(ct[key], cj[key])
    # the decoder's hidden state stays in the weights' type
    h, _ = TM.gqa_full(cfg, tb.dec_blocks[0].attn,
                       tb.embed[X.t_(X.TOKS).long()])
    assert h.dtype == torch.bfloat16


@pytest.mark.parametrize("mode", ["padded", "bucketed"])
def test_adapters_reach_prefill_only(mode):
    """ROADMAP C3: the decoder's self-attention takes the bank in
    prefill; decode never does."""
    cfg, _, tp, weights, fe = X.setup(ARCH)
    tb = X.banks(cfg, weights, mode)[1]
    lt, ct = TM.prefill(cfg, tp, X.t_(X.TOKS), frontend=X.t_(fe),
                        bank=tb.data, lora_idx=tb.lora_idx(X.t_(X.ROWS)),
                        cache_len=X.CACHE_LEN, lora_kernel="sgmv")
    nxt = lt.argmax(-1).to(torch.int32)
    with_bank, _ = TM.decode_step(
        cfg, tp, {k: v.clone() for k, v in ct.items()}, nxt, bank=tb.data,
        lora_idx=tb.lora_idx(X.t_(X.ROWS)), lora_kernel="sgmv")
    without, _ = TM.decode_step(cfg, tp, ct, nxt)
    assert torch.equal(with_bank, without)


def test_prefill_decode_consistency():
    cfg, _, tp, _, fe = X.setup(ARCH)
    X.consistency(cfg, tp, fe)


def test_padded_equals_bucketed_bit_for_bit():
    cfg, _, tp, weights, fe = X.setup(ARCH)
    got = [X.port_run(cfg, tp, X.banks(cfg, weights, mode)[1], fe)
           for mode in ("padded", "bucketed")]
    for a, b in zip(got[0][:2], got[1][:2]):
        assert torch.equal(a, b)
    for key in got[0][2]:
        assert torch.equal(got[0][2][key], got[1][2][key]), key


@pytest.mark.parametrize("decode_block", [1, 4])
@pytest.mark.parametrize("mode", ["padded", "bucketed"])
def test_engine_tokens_match_jax(mode, decode_block):
    cfg, _, tp, weights, _ = X.setup(ARCH)
    got, _ = X.serve(cfg, tp, weights, jax_side=False, bank_mode=mode,
                     lora_kernel="sgmv", decode_block=decode_block)
    assert got == _jax_tokens()
    assert [len(o) for o in got] == [n for _, _, n in X.trace(cfg)]


@pytest.mark.parametrize("mode", ["padded", "bucketed"])
def test_kernel_calls_per_prefill_group_and_decode_step(monkeypatch, mode):
    cfg, _, tp, weights, _ = X.setup(ARCH)
    calls = X.KernelCalls(monkeypatch)
    _, eng = X.serve(cfg, tp, weights, jax_side=False, bank_mode=mode,
                     lora_kernel="sgmv", decode_block=4)
    groups = eng.prefill_dispatches
    sgmv = {"padded": "B1", "bucketed": "B2"}[mode]
    n, E = cfg.n_layers, cfg.encoder.n_layers
    want = {"B1": 0, "B2": 0, "B5": (2 * n + E) * groups}
    want[sgmv] = 4 * n * groups
    assert eng.decode_iterations > 0
    M = cfg.encoder.n_frames
    # per group of prompts of S: the decoder's causal S x S, the
    # encoder's M x M and the cross-attention's S x M, all non-causal
    # but the first
    lens = sorted({len(p) for _, p, _ in X.trace(cfg)})
    assert sorted(set(calls.b5)) == sorted(
        {(True, S, S) for S in lens} | {(False, M, M)}
        | {(False, S, M) for S in lens})
    assert calls.take() == want
    # one decode step alone launches nothing
    eng._decode_fn(eng.last_token)
    assert calls.take() == {"B1": 0, "B2": 0, "B5": 0}
