"""PyTorch port, the registry's other dense configs (ROADMAP queue A item
8): qwen2.5-32b (GQA 40/8, q/k/v bias), codeqwen1.5-7b (MHA, bias),
internlm2-1.8b (GQA 16/8) and stablelm-1.6b (MHA, head dim 64). At each
smoke config, with params and nonzero-B banks made in JAX and bridged
through numpy (the JAX side's SGMV kernels in interpret mode):

* prefill and decode logits, and the KV cache, against the JAX model
  (the port's bucketed bank on its kernels' plain versions; the MHA
  configs' prefill goes through B5's plain version);
* the engine's tokens against the JAX engine's (padded and bucketed).

The registry holds the ported families only: an arch that is not ported
stays out and ``get_config`` raises ``KeyError`` on it.

Tolerances: fp32 atol = rtol = 1e-4 (``tests/test_torch_models.py``'s);
tokens exact.
"""
import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfg
import repro_torch.configs as tcfg
from _torch_jax_side import nonzero_weights
from repro.lora.bank import build_bank as jax_build_bank
from repro.models import model as JM
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine
from repro_torch import bridge
from repro_torch.lora.bank import build_bank
from repro_torch.models import model as TM
from repro_torch.serving import Request, ServingEngine

DENSE = ["qwen2.5-32b", "codeqwen1.5-7b", "internlm2-1.8b", "stablelm-1.6b"]
ADAPTERS = {"a-r8": 8, "b-r32": 32, "c-r16": 16}
ATOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(t, j):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), atol=ATOL,
                               rtol=ATOL)


def test_registry_holds_the_ported_families_only():
    # every JAX config is ported: the registry holds each arch id, and an
    # id of neither package is refused
    ported = {"llama-7b-paper", "deepseek-v2-lite-16b",
              "llama4-scout-17b-a16e", "zamba2-7b", "rwkv6-7b",
              "llama-3.2-vision-90b", "seamless-m4t-large-v2", *DENSE}
    assert set(tcfg.ARCH_IDS) == ported == set(jcfg.ARCH_IDS)
    assert {tcfg.get_config(a).family for a in ported} == {
        "dense", "moe", "hybrid", "ssm", "vlm", "audio"}
    for getter in (tcfg.get_config, tcfg.get_smoke_config):
        with pytest.raises(KeyError):
            getter("llama-3.2-vision-90b-smoke")


def _serve(cfg, params, weights, *, jax_side, **kw):
    rng = np.random.default_rng(1)
    ids = sorted(ADAPTERS)
    trace = [(ids[i % 3], [int(t) for t in rng.integers(1, cfg.vocab_size,
                                                         5 + i % 2)],
              3 + i % 2) for i in range(4)]
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
    now = time.monotonic()
    reqs = [mk(i, aid, p, n, arrival=now)
            for i, (aid, p, n) in enumerate(trace)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained(max_iters=100)
    return [r.output for r in reqs]


@pytest.mark.parametrize("arch", DENSE)
def test_dense_config_matches_jax(arch):
    cfg = jcfg.get_smoke_config(arch)
    assert dataclasses.asdict(tcfg.get_smoke_config(arch)) == \
        dataclasses.asdict(cfg)
    jp = JM.init_params(cfg, jax.random.PRNGKey(0))
    tp = bridge.params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                                  device="cpu")
    weights = nonzero_weights(cfg, ADAPTERS, 3)
    jb = jax_build_bank(cfg, ADAPTERS, jax.random.PRNGKey(1),
                        mode="bucketed")
    tb = build_bank(cfg, ADAPTERS, 1, mode="bucketed", device="cpu")
    for aid, w in weights.items():
        jb = jb.set_adapter(aid, jax.tree.map(jnp.asarray, w))
        tb.set_adapter(aid, bridge.adapter_weights_from_numpy(w, device="cpu"))
    toks = np.array([[5, 9, 2, 7, 1], [8, 8, 4, 6, 2], [3, 1, 4, 1, 5]],
                    np.int32)
    rows = np.array([0, 1, 2], np.int32)
    jidx = jb.lora_idx(jnp.asarray(rows))
    lj, cj = JM.prefill(cfg, jp, jnp.asarray(toks), bank=jb.data,
                        lora_idx=jidx, cache_len=8, cache_dtype=jnp.float32,
                        lora_kernel="sgmv")
    nxt = np.asarray(jnp.argmax(lj, -1)).astype(np.int32)
    dj, cj2 = JM.decode_step(cfg, jp, cj, jnp.asarray(nxt), bank=jb.data,
                             lora_idx=jidx, lora_kernel="sgmv")
    tidx = tb.lora_idx(_t(rows))
    lt, ct = TM.prefill(cfg, tp, _t(toks), bank=tb.data, lora_idx=tidx,
                        cache_len=8, cache_dtype=torch.float32,
                        lora_kernel="sgmv")
    dt, ct2 = TM.decode_step(cfg, tp, ct, _t(nxt), bank=tb.data,
                             lora_idx=tidx, lora_kernel="sgmv")
    _close(lt, lj)
    _close(dt, dj)
    for key in ("k", "v"):
        _close(ct2[key], cj2[key])
    want = _serve(cfg, jp, weights, jax_side=True)
    for mode in ("padded", "bucketed"):
        assert _serve(cfg, tp, weights, jax_side=False, bank_mode=mode,
                      lora_kernel="sgmv", decode_block=2) == want, mode
