"""PyTorch port, the recurrent families served (ROADMAP queue A item 10):
zamba2-7b (Mamba2 layers with one shared attention block, whose one-layer
LoRA bank serves every application of it) and rwkv6-7b (RWKV-6, adapters
on the receptance, key, value and output), at their smoke configs, with
params and nonzero-B banks made in JAX and bridged through numpy:

* prefill and decode logits and the whole cache (KV, Mamba2 and WKV
  state, token shifts) against the JAX model, both bank layouts on the
  SGMV kernels (the port's plain versions, the JAX side's Pallas kernels
  in interpret mode);
* padded == bucketed bit for bit in the port;
* the engine's tokens against the JAX engine's, padded and bucketed,
  decode blocks 1 and 4; the trace has more requests than slots, so a
  prefill lands in a slot whose state ran on while it was free.

Tolerances: fp32 atol = rtol = 1e-4; tokens and bits exact.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_jax_side import nonzero_weights
from repro.configs import get_smoke_config
from repro.lora.bank import build_bank as jax_build_bank
from repro.models import model as JM
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine
from repro_torch import bridge
from repro_torch.lora.adapter import bank_layers
from repro_torch.lora.bank import build_bank
from repro_torch.models import model as TM
from repro_torch.serving import Request, ServingEngine

ARCHS = ["zamba2-7b", "rwkv6-7b"]
ADAPTERS = {"a-r8": 8, "b-r32": 32, "c-r16": 16}
ATOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(t, j):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), atol=ATOL,
                               rtol=ATOL)


@functools.lru_cache(maxsize=None)
def _setup(arch):
    """(cfg, JAX params, port params, nonzero adapter weights as numpy)."""
    cfg = get_smoke_config(arch)
    jp = JM.init_params(cfg, jax.random.PRNGKey(0))
    tp = bridge.params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                                  device="cpu")
    return cfg, jp, tp, nonzero_weights(cfg, ADAPTERS, 3)


def _banks(cfg, weights, mode):
    L = bank_layers(cfg)
    assert L == (1 if cfg.family == "hybrid" else cfg.n_layers)
    jb = jax_build_bank(cfg, ADAPTERS, jax.random.PRNGKey(1), mode=mode,
                        n_layers=L)
    tb = build_bank(cfg, ADAPTERS, 1, mode=mode, n_layers=L, device="cpu")
    for aid, w in weights.items():
        jb = jb.set_adapter(aid, jax.tree.map(jnp.asarray, w))
        tb.set_adapter(aid, bridge.adapter_weights_from_numpy(w, device="cpu"))
    return jb, tb


TOKS = np.array([[5, 9, 2, 7, 1, 3], [8, 8, 4, 6, 2, 9],
                 [3, 1, 4, 1, 5, 9]], np.int32)
ROWS = np.array([0, 1, 2], np.int32)


def _port_logits(cfg, tp, tb):
    idx = tb.lora_idx(_t(ROWS))
    lt, ct = TM.prefill(cfg, tp, _t(TOKS), bank=tb.data, lora_idx=idx,
                        cache_len=10, cache_dtype=torch.float32,
                        lora_kernel="sgmv")
    nxt = lt.argmax(-1).to(torch.int32)
    dt, ct2 = TM.decode_step(cfg, tp, ct, nxt, bank=tb.data, lora_idx=idx,
                             lora_kernel="sgmv")
    return lt, dt, ct2


@pytest.mark.parametrize("mode", ["padded", "bucketed"])
@pytest.mark.parametrize("arch", ARCHS)
def test_logits_and_cache_match_jax(arch, mode):
    cfg, jp, tp, weights = _setup(arch)
    jb, tb = _banks(cfg, weights, mode)
    jidx = jb.lora_idx(jnp.asarray(ROWS))
    lj, cj = JM.prefill(cfg, jp, jnp.asarray(TOKS), bank=jb.data,
                        lora_idx=jidx, cache_len=10, cache_dtype=jnp.float32,
                        lora_kernel="sgmv")
    nxt = np.asarray(jnp.argmax(lj, -1)).astype(np.int32)
    dj, cj2 = JM.decode_step(cfg, jp, cj, jnp.asarray(nxt), bank=jb.data,
                             lora_idx=jidx, lora_kernel="sgmv")
    lt, dt, ct2 = _port_logits(cfg, tp, tb)
    _close(lt, lj)
    np.testing.assert_array_equal(lt.argmax(-1).numpy(), nxt)
    _close(dt, dj)
    assert set(ct2) == set(cj2)
    for key in cj2:
        assert ct2[key].shape == cj2[key].shape, key
        _close(ct2[key], cj2[key])
    # the adapters move the logits: a bank without them gives others
    plain, _ = TM.prefill(cfg, tp, _t(TOKS), cache_len=10)
    assert not torch.allclose(plain, lt, atol=1e-2)


@pytest.mark.parametrize("arch", ARCHS)
def test_padded_equals_bucketed_bit_for_bit(arch):
    cfg, _, tp, weights = _setup(arch)
    got = [_port_logits(cfg, tp, _banks(cfg, weights, mode)[1])
           for mode in ("padded", "bucketed")]
    for a, b in zip(got[0][:2], got[1][:2]):
        assert torch.equal(a, b)
    for key in got[0][2]:
        assert torch.equal(got[0][2][key], got[1][2][key]), key


def _trace(cfg):
    """5 requests over 3 adapters for 4 slots, prompts of 5 and 6
    tokens, 3 or 4 new tokens each."""
    rng = np.random.default_rng(1)
    ids = sorted(ADAPTERS)
    return [(ids[i % 3], [int(t) for t in rng.integers(1, cfg.vocab_size,
                                                       5 + i % 2)],
             3 + i % 2) for i in range(5)]


def _serve(cfg, params, weights, *, jax_side, **kw):
    if jax_side:
        eng = JaxEngine(cfg, params, dict(ADAPTERS), max_batch=4, max_len=16,
                        lora_kernel="einsum")
        mk, conv = JaxRequest, lambda w: jax.tree.map(jnp.asarray, w)
    else:
        eng = ServingEngine(cfg, params, dict(ADAPTERS), max_batch=4,
                            max_len=16, device="cpu", **kw)
        mk, conv = Request, lambda w: bridge.adapter_weights_from_numpy(
            w, device="cpu")
    for aid, r in ADAPTERS.items():
        eng.install_adapter(aid, r, conv(weights[aid]))
    reqs = [mk(i, aid, p, n, arrival=0.0)
            for i, (aid, p, n) in enumerate(_trace(cfg))]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained(max_iters=100)
    assert eng.prefill_dispatches >= 2
    return [r.output for r in reqs]


@functools.lru_cache(maxsize=None)
def _jax_tokens(arch):
    cfg, jp, _, weights = _setup(arch)
    return _serve(cfg, jp, weights, jax_side=True)


@pytest.mark.parametrize("decode_block", [1, 4])
@pytest.mark.parametrize("mode", ["padded", "bucketed"])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_tokens_match_jax(arch, mode, decode_block):
    cfg, _, tp, weights = _setup(arch)
    got = _serve(cfg, tp, weights, jax_side=False, bank_mode=mode,
                 lora_kernel="sgmv", decode_block=decode_block)
    assert got == _jax_tokens(arch)
    assert [len(o) for o in got] == [n for _, _, n in _trace(cfg)]
