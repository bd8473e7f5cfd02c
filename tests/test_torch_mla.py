"""PyTorch port, DeepSeek-V2's multi-head latent attention (MLA) and what
the MoE family changes around it, held against the JAX package at
deepseek-v2-lite-16b-smoke with weights made in JAX and bridged through
numpy:

* ``flash_attention(extra_qk=...)``: the shared rope key scored as a
  second einsum (several kv chunks, a window, non-causal);
* ``mla_full`` (out, c, kr) and ``mla_decode`` — the naive expand the
  engine runs and ``absorbed=True`` — with rows whose position ran past
  the cache (their writes dropped, as JAX drops them; ROADMAP C4), and a
  ring-indexed window;
* bf16 weights over an fp32 cache, the engine's types (the expand runs
  in the promoted type, as JAX's does);
* the ``v`` adapter sits in the bank and never moves an MLA model's
  logits (the reference applies only ``k`` in ``_mla_ckv``; ROADMAP C9);
* the bank's real bytes at MLA's widths (q 3072, k/v 576, o 2048 at full
  width) and ``EngineBackend.memory_profile``;
* both launchers take ``--arch``: ``launch.serve --servers 2`` and
  ``launch.server``'s engine cluster serve the MoE models on the CPU.

Tolerances: fp32 atol = rtol = 1e-4 (``tests/test_torch_models.py``'s);
bf16 against fp32 within 5e-2 of the largest magnitude (bf16 rounds at
every product).
"""
import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_jax_side import nonzero_weights
from repro.configs import get_smoke_config
from repro.lora.bank import build_bank as jax_build_bank
from repro.models import attention as JA
from repro.models import common as JC
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.lora.adapter import Adapter, bank_nbytes
from repro_torch.lora.bank import build_bank
from repro_torch.models import attention as TA
from repro_torch.models import common as TC
from repro_torch.models import model as TM

ARCH = "deepseek-v2-lite-16b"
ATOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), atol=atol,
                               rtol=atol)


@pytest.mark.parametrize("window,causal,chunk", [
    (0, True, 1024),       # one kv chunk
    (0, True, 4),          # several kv chunks, a ragged last one
    (3, True, 4),          # sliding window
    (0, False, 5),         # non-causal
])
def test_flash_attention_extra_qk_matches_jax(window, causal, chunk):
    rng = np.random.default_rng(window * 10 + chunk)
    B, S, H, hd, hd2, hdv = 2, 11, 4, 16, 8, 12
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, H, hdv)).astype(np.float32)
    q2 = rng.standard_normal((B, S, H, hd2)).astype(np.float32)
    k2 = rng.standard_normal((B, S, hd2)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)
    kw = dict(causal=causal, window=window, chunk_q=chunk, chunk_k=chunk,
              scale=0.2)
    ot = TC.flash_attention(_t(q), _t(k), _t(v), q_positions=_t(pos),
                            k_positions=_t(pos), extra_qk=(_t(q2), _t(k2)),
                            **kw)
    oj = JC.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            q_positions=jnp.asarray(pos),
                            k_positions=jnp.asarray(pos),
                            extra_qk=(jnp.asarray(q2), jnp.asarray(k2)), **kw)
    assert ot.shape == (B, S, H, hdv)
    _close(ot, oj)
    # the extra term is live
    plain = TC.flash_attention(_t(q), _t(k), _t(v), q_positions=_t(pos),
                               k_positions=_t(pos), **kw)
    assert (plain - ot).abs().max() > 1e-2


@pytest.fixture(scope="module")
def mla():
    cfg = get_smoke_config(ARCH)
    jp = JA.init_mla(cfg, jax.random.PRNGKey(3))
    tp = TA.MLAAttention(cfg, torch.Generator().manual_seed(3))
    assert {n for n, _ in tp.named_parameters()} == set(jp)
    with torch.no_grad():
        for name, p in tp.named_parameters():
            p.copy_(_t(jp[name]))
    return cfg, jp, tp


def test_mla_full_matches_jax(mla):
    cfg, jp, tp = mla
    x = np.random.default_rng(3).standard_normal((2, 7, 128)).astype(
        np.float32)
    pos = np.arange(7, dtype=np.int32)
    oj, (cj, krj) = JA.mla_full(cfg, jp, jnp.asarray(x), jnp.asarray(pos))
    ot, (ct, krt) = TA.mla_full(cfg, tp, _t(x))           # positions: arange
    m = cfg.mla
    assert ct.shape == (2, 7, m.kv_lora_rank)
    assert krt.shape == (2, 7, m.qk_rope_head_dim)
    _close(ot, oj)
    _close(ct, cj)
    _close(krt, krj)


def _decode_inputs(cfg, S=6):
    rng = np.random.default_rng(4)
    m = cfg.mla
    B = 3
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    cc = rng.standard_normal((B, S, m.kv_lora_rank)).astype(np.float32)
    kr = rng.standard_normal((B, S, m.qk_rope_head_dim)).astype(np.float32)
    pos = np.array([2, S, S + 5], np.int32)     # rows 1, 2 past the cache
    return x, cc, kr, pos


@pytest.mark.parametrize("absorbed", [False, True])
@pytest.mark.parametrize("window", [0, 4])
def test_mla_decode_matches_jax_including_rows_past_the_cache(mla, absorbed,
                                                              window):
    cfg, jp, tp = mla
    x, cc, kr, pos = _decode_inputs(cfg)
    oj, (cj, krj) = JA.mla_decode(cfg, jp, jnp.asarray(x), jnp.asarray(cc),
                                  jnp.asarray(kr), jnp.asarray(pos),
                                  window=window, absorbed=absorbed)
    c_t, kr_t = _t(cc), _t(kr)
    ot, (c2, kr2) = TA.mla_decode(cfg, tp, _t(x), c_t, kr_t, _t(pos),
                                  window=window, absorbed=absorbed)
    assert c2 is c_t and kr2 is kr_t                  # written in place
    _close(ot, oj)
    _close(c2, cj)
    _close(kr2, krj)
    if not window:      # rows past the cache left their slots untouched
        np.testing.assert_array_equal(c2[1:].numpy(), cc[1:])
        np.testing.assert_array_equal(kr2[1:].numpy(), kr[1:])


def test_absorbed_decode_equals_the_naive_expand(mla):
    cfg, _, tp = mla
    x, cc, kr, pos = _decode_inputs(cfg)
    outs = [TA.mla_decode(cfg, tp, _t(x), _t(cc), _t(kr), _t(pos),
                          absorbed=a)[0] for a in (False, True)]
    _close(outs[0], outs[1].numpy())


@pytest.mark.parametrize("absorbed", [False, True])
def test_bf16_weights_over_an_fp32_cache(mla, absorbed):
    """The engine's types: bf16 params, an fp32 cache. The naive expand
    runs in fp32 (the promoted type); the output comes back in bf16 and
    lies within bf16's reach of the fp32 module's."""
    cfg, _, tp = mla
    x, cc, kr, pos = _decode_inputs(cfg)
    pos = np.array([2, 3, 5], np.int32)
    ref, _ = TA.mla_decode(cfg, tp, _t(x), _t(cc), _t(kr), _t(pos),
                           absorbed=absorbed)
    half = TA.MLAAttention(cfg, torch.Generator(), torch.bfloat16)
    with torch.no_grad():
        for (_, p), (_, q) in zip(half.named_parameters(),
                                  tp.named_parameters()):
            p.copy_(q)
    c_t = _t(cc)
    out, _ = TA.mla_decode(cfg, half, _t(x).to(torch.bfloat16), c_t, _t(kr),
                           _t(pos), absorbed=absorbed)
    assert out.dtype == torch.bfloat16 and c_t.dtype == torch.float32
    scale = ref.abs().max().item()
    assert (out.float() - ref).abs().max().item() <= 5e-2 * scale


# ---------------------------------------------------------------------------
# the model: the v adapter, the bank's bytes, the launchers
# ---------------------------------------------------------------------------

ADAPTERS = {"a-r8": 8, "b-r16": 16}


@pytest.mark.parametrize("kernel", ["einsum", "sgmv"])
def test_v_adapter_never_reaches_mla(kernel):
    """The reference applies only the ``k`` hook to ``w_dkv``
    (``repro/models/attention.py:_mla_ckv``); the ``v`` adapter's weights
    sit in the bank and change nothing. The port's logits with v's B
    scaled by 100 equal the logits without, bit for bit, while the same
    scaling of k's B moves them (``test_torch_moe.py`` holds these
    logits against the JAX package's)."""
    cfg = get_smoke_config(ARCH)
    tp = TM.init_params(cfg, 0, device="cpu")
    toks = _t(np.array([[5, 9, 2, 7], [8, 1, 4, 6]], np.int32))
    rows = _t(np.array([0, 1], np.int32))
    logits = {}
    for target, boost in (("v", 1.0), ("v", 100.0), ("k", 100.0)):
        w = nonzero_weights(cfg, ADAPTERS, 7)
        for a in w.values():
            a[target]["B"] = a[target]["B"] * boost
        tb = build_bank(cfg, ADAPTERS, 1, device="cpu")
        for aid, x in w.items():
            tb.set_adapter(aid, bridge.adapter_weights_from_numpy(
                x, device="cpu"))
        lt, _ = TM.prefill(cfg, tp, toks, bank=tb.data,
                           lora_idx=tb.lora_idx(rows), lora_kernel=kernel)
        logits[(target, boost)] = lt.numpy()
    np.testing.assert_array_equal(logits[("v", 1.0)], logits[("v", 100.0)])
    assert np.abs(logits[("k", 100.0)] - logits[("v", 1.0)]).max() > 1e-2


@pytest.mark.parametrize("arch", [ARCH, "llama4-scout-17b-a16e"])
def test_bank_bytes_at_the_full_widths(arch):
    """A one-adapter bf16 bank holds exactly ``Adapter.nbytes`` (every
    target at its own widths) at full width, in both layouts; an fp32
    bank of several adapters holds the JAX package's bytes."""
    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, n_layers=1)
    for mode in ("padded", "bucketed"):
        one = build_bank(cfg, {"a-r16": 16}, 0, mode=mode,
                         dtype=torch.bfloat16, device="cpu")
        assert one.nbytes() == Adapter("a-r16", 16).nbytes(cfg)
        data = one.data if mode == "padded" else one.data[0]
        if cfg.mla is not None:
            assert {t: tuple(w["B"].shape[-1:]) for t, w in data.items()} \
                == {"q": (3072,), "k": (576,), "v": (576,), "o": (2048,)}
            assert data["o"]["A"].shape[-2] == 2048
        else:
            assert {t: tuple(w["B"].shape[-1:]) for t, w in data.items()} \
                == {"q": (5120,), "k": (1024,), "v": (1024,), "o": (5120,)}
    small = get_smoke_config(arch)
    for mode in ("padded", "bucketed"):
        jb = jax_build_bank(small, ADAPTERS, jax.random.PRNGKey(1),
                            mode=mode)
        tb = build_bank(small, ADAPTERS, 1, mode=mode, device="cpu")
        assert tb.nbytes() == jb.nbytes() == bank_nbytes(tb.data)


def test_serve_launcher_takes_arch(monkeypatch, capsys):
    from repro_torch.launch import serve
    monkeypatch.setattr("sys.argv", [
        "serve", "--arch", ARCH, "--config", "smoke", "--device", "cpu",
        "--servers", "2", "--requests", "6", "--duration", "1",
        "--prompt-lens", "5,7", "--max-new", "3", "--bank-mode", "bucketed",
        "--decode-block", "2", "--dtype", "float32"])
    serve.main()
    out = capsys.readouterr().out
    assert f"model={ARCH}-smoke" in out and "finished=6/6" in out
    assert "cluster drained OK" in out
    lines = [x for x in out.splitlines() if x.startswith("server ")]
    assert len(lines) == 2
    assert all(int(x.split("bank_bytes=")[1].split()[0]) > 0
               for x in lines if "bank_adapters=0" not in x)


def test_gateway_launcher_builds_an_moe_cluster():
    """``launch.server``'s engine cluster over ``--arch``: the engines
    hold the MoE model, and ``memory_profile`` reports each bank's real
    bytes at its widths."""
    from repro_torch.launch import server
    args = argparse.Namespace(
        arch="llama4-scout-17b-a16e", config="smoke", dtype="float32",
        device="cpu", bank_mode="padded", decode_block=1, servers=2,
        adapters=4, policy="loraserve", rebalance_period=5.0, max_len=32,
        seed=0)
    cluster = server.build_engine_cluster(args)
    be = cluster.backend
    engines = [e for e in be.engines if e is not None]
    assert engines and all(e.cfg.name == "llama4-scout-17b-a16e-smoke"
                           for e in engines)
    for eng, mem in zip(be.engines, be.memory_profile()):
        if eng is not None:
            assert mem["adapter_bytes"] == bank_nbytes(eng.bank) > 0
            assert eng.bank["k"]["B"].shape[-1] == 64      # Kv 2 x hd 32
