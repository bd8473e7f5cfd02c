"""PyTorch port, ``lora.adapter.merge_adapter`` (ROADMAP queue A item 7)
held against the JAX package's: one adapter with nonzero A and B, made
in numpy from a seed, merged into base weights made in JAX and bridged.

* The merged model's prefill logits equal the JAX merged model's (fp32,
  atol = rtol = 1e-4), for MHA, GQA with biases and MLA (whose k and v
  targets have no weight of their own and are skipped in both).
* They equal the port's own LoRA path for that adapter alone: the same
  function computed in another order, held at the JAX package's own
  tolerance for it (``tests/test_models_features.py``: atol 2e-3). At
  MLA the LoRA path puts the k adapter on ``w_dkv`` (ROADMAP C9) and the
  merge, as the reference's, has no weight to put it on (C14), so there
  the k and v adapters are zero on both sides.
* The input model is left as it was, and every parameter the merge does
  not touch is shared, not copied.
* The tree forms the reference refuses (no uniform stack of attention
  blocks: the hybrid and SSM families) raise in both.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_jax_side import nonzero_weights
from repro.configs import get_smoke_config
from repro.lora.adapter import merge_adapter as jax_merge_adapter
from repro.models import model as JM
from repro_torch import bridge
from repro_torch.lora.adapter import merge_adapter
from repro_torch.lora.bank import build_bank
from repro_torch.models import model as TM

ARCHS = ["llama-7b-paper", "qwen2.5-32b", "deepseek-v2-lite-16b"]
ADAPTER = {"hot-r16": 16}
TOKS = np.array([[5, 9, 2, 7, 1, 3], [8, 8, 4, 6, 2, 9]], np.int32)
ATOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def _setup(arch):
    cfg = get_smoke_config(arch)
    jp = JM.init_params(cfg, jax.random.PRNGKey(0))
    tp = bridge.params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                                  device="cpu")
    return cfg, jp, tp, nonzero_weights(cfg, ADAPTER, 8, scale=0.1)


def _jax_adapter(w):
    return jax.tree.map(jnp.asarray, w)


@pytest.mark.parametrize("arch", ARCHS)
def test_merged_logits_match_jax(arch):
    cfg, jp, tp, weights = _setup(arch)
    w = weights["hot-r16"]
    jm = jax_merge_adapter(jp, _jax_adapter(w), cfg, scaling=0.5)
    tm = merge_adapter(tp, bridge.adapter_weights_from_numpy(
        w, device="cpu"), cfg,
                       scaling=0.5)
    lj, _ = JM.prefill(cfg, jm, jnp.asarray(TOKS))
    lt, _ = TM.prefill(cfg, tm, _t(TOKS))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL,
                               rtol=ATOL)
    base, _ = TM.prefill(cfg, tp, _t(TOKS))
    assert not torch.allclose(base, lt, atol=1e-2)   # the merge moved them


@pytest.mark.parametrize("arch", ARCHS)
def test_merged_logits_match_the_lora_path(arch):
    """Merged weights against the SGMV path of a bank holding that
    adapter (with two others), every row on it."""
    cfg, _, tp, weights = _setup(arch)
    if cfg.mla is not None:
        weights = {aid: {t: {k: v * (t in ("q", "o"))
                             for k, v in ab.items()}
                         for t, ab in w.items()}
                   for aid, w in weights.items()}
    others = nonzero_weights(cfg, {"x-r8": 8, "y-r32": 32}, 9)
    ranks = {"hot-r16": 16, "x-r8": 8, "y-r32": 32}
    bank = build_bank(cfg, ranks, 1, mode="bucketed", device="cpu")
    for aid, w in {**weights, **others}.items():
        bank.set_adapter(aid, bridge.adapter_weights_from_numpy(
            w, device="cpu"))
    rows = torch.full((2,), bank.index("hot-r16"), dtype=torch.int32)
    lora, _ = TM.prefill(cfg, tp, _t(TOKS), bank=bank.data,
                         lora_idx=bank.lora_idx(rows), lora_kernel="sgmv")
    merged = merge_adapter(tp, bridge.adapter_weights_from_numpy(
        weights["hot-r16"], device="cpu"), cfg)
    lm, _ = TM.prefill(cfg, merged, _t(TOKS))
    np.testing.assert_allclose(lm.numpy(), lora.numpy(), atol=2e-3)


def test_merge_leaves_the_input_and_shares_the_rest():
    cfg, _, tp, weights = _setup("llama-7b-paper")
    before = {n: p.clone() for n, p in tp.named_parameters()}
    adapter = bridge.adapter_weights_from_numpy(weights["hot-r16"],
                                                device="cpu")
    del adapter["k"]                        # a target the adapter lacks
    merged = merge_adapter(tp, adapter, cfg)
    for n, p in tp.named_parameters():
        assert torch.equal(p, before[n]), n
    new = dict(merged.named_parameters())
    for n, p in tp.named_parameters():
        touched = n.split(".")[-1] in ("wq", "wv", "wo")
        assert (new[n] is p) != touched, n
        if touched:
            assert not torch.equal(new[n], p), n


@pytest.mark.parametrize("arch", ["zamba2-7b", "rwkv6-7b"])
def test_merge_refuses_what_the_reference_refuses(arch):
    cfg = get_smoke_config(arch)
    jp = JM.init_params(cfg, jax.random.PRNGKey(0))
    w = nonzero_weights(cfg, ADAPTER, 8)["hot-r16"]
    # the reference: no "blocks" (hybrid) raises ValueError, blocks with
    # no "attn" (RWKV-6) a KeyError; the port raises ValueError for both
    with pytest.raises((ValueError, KeyError)):
        jax_merge_adapter(jp, _jax_adapter(w), cfg)
    tp = bridge.params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                                  device="cpu")
    with pytest.raises(ValueError, match="uniform-stack"):
        merge_adapter(tp, bridge.adapter_weights_from_numpy(
            w, device="cpu"), cfg)
