"""Shared side of the PyTorch port's tests of the encoder-decoder and VLM
families (``test_torch_audio.py``, ``test_torch_vlm.py``): params made in
JAX and bridged through numpy, nonzero adapter weights, a nonzero
frontend and nonzero gates, the two packages' prefill + decode, their
engines' tokens, and a count of the kernel calls the port makes.

The engines feed the reference's zero frontend, which the families turn
into an exact 0 (the encoder's memory, the cross K/V); the model-level
runs here feed N(0, 0.02^2) frontends, as ``tests/test_models_smoke.py``
does. The VLM's gates are 0 at init, which makes its cross blocks the
identity, so ``setup`` sets them nonzero in the JAX tree before bridging
(the counterpart of a nonzero LoRA B, ROADMAP C1).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_jax_side import nonzero_weights
from repro.configs import get_smoke_config
from repro.lora.bank import build_bank as jax_build_bank
from repro.models import model as JM
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine
from repro_torch import bridge
from repro_torch.kernels import ops
from repro_torch.lora.adapter import bank_layers
from repro_torch.lora.bank import build_bank
from repro_torch.models import attention as TA
from repro_torch.models import model as TM
from repro_torch.serving import Request, ServingEngine

ADAPTERS = {"a-r8": 8, "b-r32": 32, "c-r16": 16}
ATOL = 1e-4
BF16_TOL = 5e-2
TOKS = np.array([[5, 9, 2, 7, 1, 3], [8, 8, 4, 6, 2, 9],
                 [3, 1, 4, 1, 5, 9]], np.int32)
ROWS = np.array([0, 1, 2], np.int32)
CACHE_LEN = 10


def t_(a):
    return torch.from_numpy(np.array(a))


def close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), atol=atol,
                               rtol=atol)


def close_bf16(t, j):
    """Within 5e-2 of the reference's largest magnitude."""
    t, j = t.detach().float().numpy(), np.asarray(j, np.float32)
    err = np.abs(t - j).max()
    assert err <= BF16_TOL * np.abs(j).max(), (err, np.abs(j).max())


def frontend_len(cfg):
    return cfg.encoder.n_frames if cfg.encoder else cfg.n_frontend_tokens


def nonzero_frontend(cfg, B, seed):
    """(B, M, d) fp32 frames or patches, N(0, 0.02^2), from a seed."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, frontend_len(cfg), cfg.d_model))
            * 0.02).astype(np.float32)


@functools.lru_cache(maxsize=None)
def setup(arch, n_layers=None, gates=True):
    """(cfg, JAX params, port params (fp32), adapter weights, frontend
    (3 rows)); the VLM's gates nonzero unless ``gates`` is False."""
    cfg = get_smoke_config(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    jp = JM.init_params(cfg, jax.random.PRNGKey(0))
    if cfg.family == "vlm" and gates:
        rng = np.random.default_rng(5)
        cb = dict(jp["cross_blocks"])
        for g in ("gate_attn", "gate_ffn"):
            cb[g] = jnp.asarray(rng.uniform(0.3, 1.0, cb[g].shape) *
                                rng.choice([-1, 1], cb[g].shape),
                                jnp.float32)
        jp = {**jp, "cross_blocks": cb}
    tp = bridge.params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                                  device="cpu")
    return cfg, jp, tp, nonzero_weights(cfg, ADAPTERS, 3), \
        nonzero_frontend(cfg, len(TOKS), 4)


@functools.lru_cache(maxsize=None)
def bf16_setup(arch, n_layers=None):
    """The same params rounded to bf16 on both sides."""
    cfg, jp, _, weights, fe = setup(arch, n_layers)
    jb = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
    tb = bridge.params_from_numpy(
        cfg, jax.tree.map(lambda a: np.asarray(a, np.float32), jb),
        device="cpu", dtype=torch.bfloat16)
    return cfg, jb, tb, weights, fe


def banks(cfg, weights, mode):
    L = bank_layers(cfg)
    jb = jax_build_bank(cfg, ADAPTERS, jax.random.PRNGKey(1), mode=mode,
                        n_layers=L)
    tb = build_bank(cfg, ADAPTERS, 1, mode=mode, n_layers=L, device="cpu")
    for aid, w in weights.items():
        jb = jb.set_adapter(aid, jax.tree.map(jnp.asarray, w))
        tb.set_adapter(aid, bridge.adapter_weights_from_numpy(w, device="cpu"))
    return jb, tb


def jax_run(cfg, jp, jb, fe, cache_dtype=jnp.float32):
    """JAX prefill (the Pallas SGMV kernels in interpret mode) and one
    decode step of its argmax: (prefill logits, decode logits, the cache
    after both)."""
    idx = None if jb is None else jb.lora_idx(jnp.asarray(ROWS))
    data = None if jb is None else jb.data
    lj, cj = JM.prefill(cfg, jp, jnp.asarray(TOKS), frontend=jnp.asarray(fe),
                        bank=data, lora_idx=idx, cache_len=CACHE_LEN,
                        cache_dtype=cache_dtype, lora_kernel="sgmv")
    nxt = jnp.argmax(lj, -1).astype(jnp.int32)
    dj, cj2 = JM.decode_step(cfg, jp, cj, nxt, bank=data, lora_idx=idx,
                             lora_kernel="sgmv")
    return lj, dj, cj2


def port_run(cfg, tp, tb, fe, kernel="sgmv", cache_dtype=torch.float32,
             nxt=None):
    """The port's ``jax_run``; ``nxt`` (JAX logits) decodes their argmax
    in place of the port's own (a bf16 near-tie may pick another)."""
    idx = None if tb is None else tb.lora_idx(t_(ROWS))
    data = None if tb is None else tb.data
    lt, ct = TM.prefill(cfg, tp, t_(TOKS), frontend=t_(fe), bank=data,
                        lora_idx=idx, cache_len=CACHE_LEN,
                        cache_dtype=cache_dtype, lora_kernel=kernel)
    nxt = (lt if nxt is None else t_(nxt)).argmax(-1).to(torch.int32)
    dt, ct2 = TM.decode_step(cfg, tp, ct, nxt, bank=data, lora_idx=idx,
                             lora_kernel=kernel)
    return lt, dt, ct2


def check_run(port, ref):
    """Logits and every cache entry within 1e-4 (fp32)."""
    lt, dt, ct = port
    lj, dj, cj = ref
    close(lt, lj)
    np.testing.assert_array_equal(lt.argmax(-1).numpy(),
                                  np.asarray(jnp.argmax(lj, -1)))
    close(dt, dj)
    assert set(ct) == set(cj)
    for key in cj:
        assert tuple(ct[key].shape) == cj[key].shape, key
        close(ct[key], cj[key])


def consistency(cfg, tp, fe):
    """Prefill of S tokens then one decode step against the prefill of
    all S + 1 tokens: the last logits agree within 1e-3 of the largest
    (``tests/test_models_smoke.py:test_prefill_decode_consistency``, whose
    teacher-forced ``forward`` the serving port does not have)."""
    toks = t_(TOKS)
    S = toks.shape[1] - 1
    _, cache = TM.prefill(cfg, tp, toks[:, :S], frontend=t_(fe),
                          cache_len=S + 4)
    dec, _ = TM.decode_step(cfg, tp, cache, toks[:, S])
    full, _ = TM.prefill(cfg, tp, toks, frontend=t_(fe))
    rel = (full - dec).abs().max() / (full.abs().max() + 1e-9)
    assert rel < 1e-3, rel


def trace(cfg):
    """5 requests over 3 adapters for 4 slots, prompts of 5 and 6 tokens,
    3 or 4 new tokens each."""
    rng = np.random.default_rng(1)
    ids = sorted(ADAPTERS)
    return [(ids[i % 3], [int(t) for t in rng.integers(1, cfg.vocab_size,
                                                       5 + i % 2)],
             3 + i % 2) for i in range(5)]


def serve(cfg, params, weights, *, jax_side, **kw):
    """The trace through the JAX engine (einsum) or the port's (``kw``):
    each request's tokens, and the engine."""
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
            for i, (aid, p, n) in enumerate(trace(cfg))]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained(max_iters=100)
    assert eng.prefill_dispatches >= 2
    return [r.output for r in reqs], eng


class KernelCalls:
    """Counts, while installed, the calls the port would launch on a card:
    B1 and B2 under the names the SGMV dispatchers call them by
    (``kernels/ops.py``) and B5 under ``models/attention.py``'s, with
    B5's (causal, Sq, Sk). On the CPU each wrapper runs its plain version
    and counts no launch of its own."""

    def __init__(self, monkeypatch):
        self.n = {"B1": 0, "B2": 0, "B5": 0}
        self.b5 = []
        for mod, name, kid in ((ops, "sgmv_fused_blocks", "B1"),
                               (ops, "sgmv_multibank_blocks", "B2"),
                               (TA, "flash_mha", "B5")):
            monkeypatch.setattr(mod, name, self._counter(kid,
                                                         getattr(mod, name)))

    def _counter(self, kid, fn):
        def call(*args, **kw):
            self.n[kid] += 1
            if kid == "B5":
                self.b5.append((kw.get("causal", True), args[0].shape[2],
                                args[1].shape[2]))
            return fn(*args, **kw)
        return call

    def take(self):
        out, self.n = self.n, dict.fromkeys(self.n, 0)
        self.b5 = []
        return out
