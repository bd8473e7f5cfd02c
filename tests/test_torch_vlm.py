"""PyTorch port, the VLM family served: llama-3.2-vision-90b at its smoke
config (5 layers: one period of 4 self-attention layers and a gated
cross-attention block) and at 10 layers (two periods, where a wrong
interleaving of the blocks or of the cache entries would show), with
params, nonzero gates, a nonzero-B LoRA bank and a nonzero frontend
(N(0, 0.02^2) patches) made in numpy and JAX and bridged:

* prefill and decode logits and every cache entry (``k``/``v`` of the
  self-attention layers, ``xk``/``xv`` of the cross blocks) against
  JAX, with each bank layout passed in;
* bf16 weights under an fp32 frontend within the bf16 tolerance of JAX;
* the frontend moves the logits through nonzero gates; with the gates
  at their init value 0 it moves them by exactly nothing;
* no adapter reaches the VLM (ROADMAP C3): a bank changes no bit;
* prefill + one decode step against the prefill of one more token;
* padded == bucketed bit for bit;
* the engine's tokens against the JAX engine's, padded and bucketed,
  decode blocks 1 and 4;
* no call of B1, B2 or B5 (GQA: the attention runs on
  ``flash_attention``).

Tolerances: fp32 atol = rtol = 1e-4; bf16 5e-2 of the largest logit;
tokens and bits exact.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_cross_families as X
from repro_torch.models import model as TM

ARCH = "llama-3.2-vision-90b"
LAYERS = [5, 10]


@functools.lru_cache(maxsize=None)
def _jax_run(n_layers):
    """The bank is passed and, as in the reference, never applied."""
    cfg, jp, _, weights, fe = X.setup(ARCH, n_layers)
    return X.jax_run(cfg, jp, X.banks(cfg, weights, "padded")[0], fe)


@functools.lru_cache(maxsize=None)
def _jax_tokens(n_layers):
    cfg, jp, _, weights, _ = X.setup(ARCH, n_layers)
    return X.serve(cfg, jp, weights, jax_side=True)[0]


@pytest.mark.parametrize("n_layers", LAYERS)
def test_layout_of_the_periods(n_layers):
    cfg, _, tp, _, _ = X.setup(ARCH, n_layers)
    n_cross = n_layers // cfg.cross_attn_every
    assert len(tp.cross_blocks) == TM.n_cross_applications(cfg) == n_cross
    assert len(tp.self_blocks) == TM.n_attn_applications(cfg) == \
        n_layers - n_cross
    assert tp.cross_blocks[0].gate_attn.shape == (1,)
    assert all(b.gate_attn.item() != 0 and b.gate_ffn.item() != 0
               for b in tp.cross_blocks)


@pytest.mark.parametrize("mode", ["padded", "bucketed"])
@pytest.mark.parametrize("n_layers", LAYERS)
def test_prefill_decode_logits_and_caches_match_jax(n_layers, mode):
    cfg, _, tp, weights, fe = X.setup(ARCH, n_layers)
    tb = X.banks(cfg, weights, mode)[1]
    X.check_run(X.port_run(cfg, tp, tb, fe), _jax_run(n_layers))


@pytest.mark.parametrize("n_layers", LAYERS)
def test_bf16_weights_under_an_fp32_frontend_match_jax(n_layers):
    cfg, jb, tb, _, fe = X.bf16_setup(ARCH, n_layers)
    lj, dj, cj = X.jax_run(cfg, jb, None, fe, cache_dtype=jnp.bfloat16)
    lt, dt, ct = X.port_run(cfg, tb, None, fe, cache_dtype=torch.bfloat16,
                            nxt=lj)
    X.close_bf16(lt, lj)
    X.close_bf16(dt, dj)
    for key in ("k", "v", "xk", "xv"):
        X.close_bf16(ct[key], cj[key])


@pytest.mark.parametrize("n_layers", LAYERS)
def test_frontend_reaches_the_logits_through_the_gates(n_layers):
    zero = np.zeros_like(X.setup(ARCH, n_layers)[4])
    moved = {}
    for gates in (True, False):
        cfg, _, tp, _, fe = X.setup(ARCH, n_layers, gates)
        lt, dt, _ = X.port_run(cfg, tp, None, fe)
        l0, d0, _ = X.port_run(cfg, tp, None, zero)
        moved[gates] = ((lt - l0).abs().max().item(),
                        (dt - d0).abs().max().item())
    assert min(moved[True]) > 1e-3, moved
    assert moved[False] == (0.0, 0.0), moved


@pytest.mark.parametrize("n_layers", LAYERS)
def test_no_adapter_reaches_the_vlm(n_layers):
    cfg, _, tp, weights, fe = X.setup(ARCH, n_layers)
    plain = X.port_run(cfg, tp, None, fe)
    banked = X.port_run(cfg, tp, X.banks(cfg, weights, "padded")[1], fe)
    for a, b in zip(plain[:2], banked[:2]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n_layers", LAYERS)
def test_prefill_decode_consistency(n_layers):
    cfg, _, tp, _, fe = X.setup(ARCH, n_layers)
    X.consistency(cfg, tp, fe)


@pytest.mark.parametrize("n_layers", LAYERS)
def test_padded_equals_bucketed_bit_for_bit(n_layers):
    cfg, _, tp, weights, fe = X.setup(ARCH, n_layers)
    got = [X.port_run(cfg, tp, X.banks(cfg, weights, mode)[1], fe)
           for mode in ("padded", "bucketed")]
    for a, b in zip(got[0][:2], got[1][:2]):
        assert torch.equal(a, b)
    for key in got[0][2]:
        assert torch.equal(got[0][2][key], got[1][2][key]), key


@pytest.mark.parametrize("decode_block", [1, 4])
@pytest.mark.parametrize("mode", ["padded", "bucketed"])
@pytest.mark.parametrize("n_layers", LAYERS)
def test_engine_tokens_match_jax(n_layers, mode, decode_block):
    cfg, _, tp, weights, _ = X.setup(ARCH, n_layers)
    got, _ = X.serve(cfg, tp, weights, jax_side=False, bank_mode=mode,
                     lora_kernel="sgmv", decode_block=decode_block)
    assert got == _jax_tokens(n_layers)
    assert [len(o) for o in got] == [n for _, _, n in X.trace(cfg)]


@pytest.mark.parametrize("n_layers", LAYERS)
def test_no_kernel_calls(monkeypatch, n_layers):
    cfg, _, tp, weights, _ = X.setup(ARCH, n_layers)
    calls = X.KernelCalls(monkeypatch)
    for mode in ("padded", "bucketed"):
        _, eng = X.serve(cfg, tp, weights, jax_side=False, bank_mode=mode,
                         lora_kernel="sgmv", decode_block=4)
        assert eng.decode_iterations > 0
    assert calls.take() == {"B1": 0, "B2": 0, "B5": 0}
