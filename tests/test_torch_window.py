"""PyTorch port, the sliding-window ring cache at model level (ROADMAP R1):
``models/model.py:_write_prefill_kv``'s ring branch (a prompt longer than
the cache keeps its last entries at their ring slots) and decode steps
that wrap around the ring, held against the JAX package in fp32 with
params made in JAX and bridged through numpy.

Window 8 over an 8-slot cache: a 12-token prefill (the ring branch) and
a 6-token one (the plain branch, whose decode then wraps), each followed
by 6 decode steps, on the smoke configs of llama-7b-paper (GQA),
deepseek-v2-lite-16b (MLA's compressed cache), zamba2-7b (the shared
attention block), llama-3.2-vision-90b (the self-attention layers between
the cross blocks) and seamless-m4t-large-v2 (the decoder's
self-attention; the cross K/V are not windowed). The VLM and audio runs
take a nonzero frontend and the VLM's gates are nonzero
(``_torch_cross_families.setup``).

Tolerance: fp32 atol = rtol = 1e-4 on every step's logits and on the
cache after the last step.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_cross_families as X
from repro.configs import get_smoke_config
from repro.models import model as JM
from repro_torch import bridge
from repro_torch.models import model as TM

WINDOW = 8
STEPS = 6
ARCHS = ["llama-7b-paper", "deepseek-v2-lite-16b", "zamba2-7b",
         "llama-3.2-vision-90b", "seamless-m4t-large-v2"]


@functools.lru_cache(maxsize=None)
def _setup(arch):
    """(cfg, JAX params, port params, frontend or None)."""
    if arch in ("llama-3.2-vision-90b", "seamless-m4t-large-v2"):
        cfg, jp, tp, _, fe = X.setup(arch)
        return cfg, jp, tp, fe[:2]
    cfg = get_smoke_config(arch)
    jp = JM.init_params(cfg, jax.random.PRNGKey(0))
    return cfg, jp, bridge.params_from_numpy(
        cfg, jax.tree.map(np.asarray, jp), device="cpu"), None


def _run(prefill, decode, cfg, params, toks, fe, asarray, argmax):
    """Prefill ``toks`` into an 8-slot cache at window 8, then decode the
    argmax STEPS times: every step's logits and the last cache."""
    kw = {} if fe is None else {"frontend": asarray(fe)}
    logits, cache = prefill(cfg, params, asarray(toks), cache_len=WINDOW,
                            window=WINDOW, **kw)
    out = [logits]
    for _ in range(STEPS):
        logits, cache = decode(cfg, params, cache, argmax(logits),
                               window=WINDOW)
        out.append(logits)
    return out, cache


@pytest.mark.parametrize("S", [12, 6])
@pytest.mark.parametrize("arch", ARCHS)
def test_ring_cache_matches_jax(arch, S):
    cfg, jp, tp, fe = _setup(arch)
    toks = np.random.default_rng(S).integers(1, cfg.vocab_size,
                                             (2, S)).astype(np.int32)
    lj, cj = _run(JM.prefill, JM.decode_step, cfg, jp, toks, fe,
                  jnp.asarray,
                  lambda lg: jnp.argmax(lg, -1).astype(jnp.int32))
    lt, ct = _run(TM.prefill, TM.decode_step, cfg, tp, toks, fe, X.t_,
                  lambda lg: lg.argmax(-1).to(torch.int32))
    for t, j in zip(lt, lj):
        X.close(t, j)
    assert set(ct) == set(cj)
    for key in cj:
        assert tuple(ct[key].shape) == cj[key].shape, key
        X.close(ct[key], cj[key])
    assert ct["pos"].tolist() == [S + STEPS] * 2
