"""PyTorch port, the unfused SGMV pair B3a/B3b and the dispatchers on it
(``ops.sgmv``, ``bgmv``, ``sgmv_rank_bucketed`` and
``lora.batched.apply_bank_sgmv(fused=False)``), held against the JAX
package (Pallas in interpret mode) on the same numpy inputs, and the
port's own bit-for-bit promises: ``sgmv == sgmv_fused`` and
``sgmv_rank_bucketed == sgmv_bucketed_fused``.

Tolerances: fp32 atol = rtol = 1e-4 across frameworks (other sum
orders); bf16 5e-2, the JAX suite's (test_kernels_sgmv.py:33); the
bit-identity pairs exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.kernels import ops as jops
from repro.lora.bank import build_bank as jax_build_bank
from repro.lora.batched import apply_bank_sgmv as jax_apply_bank_sgmv
from repro_torch import bridge
from repro_torch.kernels import flash as tflash
from repro_torch.kernels import ops as tops
from repro_torch.kernels import sgmv as tsgmv
from repro_torch.lora.batched import apply_bank_sgmv

TOL = {"float32": 1e-4, "bfloat16": 5e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _t(a, dtype="float32"):
    return torch.from_numpy(np.array(a)).to(TDT[dtype])


def _j(a, dtype="float32"):
    return jnp.asarray(a).astype(JDT[dtype])


def _np(y):
    if isinstance(y, torch.Tensor):
        return y.float().numpy()
    return np.asarray(y.astype(jnp.float32))


def _inputs(T, d, r, do, Na, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, d)).astype(np.float32)
    A = (rng.standard_normal((Na, d, r)) * 0.05).astype(np.float32)
    B = (rng.standard_normal((Na, r, do)) * 0.05).astype(np.float32)
    aid = rng.integers(0, Na, T).astype(np.int32)
    return x, A, B, aid


# ---------------------------------------------------------------------------
# sgmv / bgmv vs JAX
# ---------------------------------------------------------------------------

SGMV_SHAPES = [             # test_kernels_sgmv.py:13-20
    (7, 128, 8, 128, 2, 8),
    (32, 256, 16, 512, 4, 16),
    (63, 512, 64, 256, 5, 16),
    (16, 128, 128, 1024, 3, 4),
    (1, 128, 8, 128, 1, 8),
    (48, 384, 32, 384, 6, 1),       # bt = 1 == BGMV
]


@pytest.mark.parametrize("T,d,r,do,Na,bt", SGMV_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sgmv_matches_jax(T, d, r, do, Na, bt, dtype):
    x, A, B, aid = _inputs(T, d, r, do, Na, T * 7 + d)
    yj = jops.sgmv(_j(x, dtype), _j(A, dtype), _j(B, dtype),
                   jnp.asarray(aid), block_t=bt, interpret=True)
    yt = tops.sgmv(_t(x, dtype), _t(A, dtype), _t(B, dtype),
                   torch.from_numpy(aid), block_t=bt)
    assert yt.dtype == TDT[dtype] and yt.shape == (T, do)
    np.testing.assert_allclose(_np(yt), _np(yj), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.parametrize("case", ["scaling", "zero_padded_rank", "bgmv"])
def test_sgmv_contract_cases_match_jax(case):
    """test_kernels_sgmv.py's scaling and inert-padding cases, and
    ``bgmv``, each against JAX and against the port's own expectation."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((16, 128)).astype(np.float32)
    A8 = (rng.standard_normal((2, 128, 8)) * 0.1).astype(np.float32)
    B8 = (rng.standard_normal((2, 8, 128)) * 0.1).astype(np.float32)
    aid = rng.integers(0, 2, 16).astype(np.int32)
    args_t = (_t(x), _t(A8), _t(B8), torch.from_numpy(aid))
    args_j = (jnp.asarray(x), jnp.asarray(A8), jnp.asarray(B8),
              jnp.asarray(aid))
    if case == "scaling":
        yt = tops.sgmv(*args_t, scaling=2.0)
        yj = jops.sgmv(*args_j, scaling=2.0, interpret=True)
        np.testing.assert_allclose(yt.numpy(),
                                   2 * tops.sgmv(*args_t).numpy(), rtol=1e-5)
    elif case == "zero_padded_rank":
        A64 = np.pad(A8, ((0, 0), (0, 0), (0, 56)))
        B64 = np.pad(B8, ((0, 0), (0, 56), (0, 0)))
        yt = tops.sgmv(_t(x), _t(A64), _t(B64), torch.from_numpy(aid))
        yj = jops.sgmv(jnp.asarray(x), jnp.asarray(A64), jnp.asarray(B64),
                       jnp.asarray(aid), interpret=True)
        np.testing.assert_allclose(yt.numpy(), tops.sgmv(*args_t).numpy(),
                                   atol=1e-5)
    else:
        yt = tops.bgmv(*args_t, scaling=0.5)
        yj = jops.bgmv(*args_j, scaling=0.5, interpret=True)
        np.testing.assert_allclose(yt.numpy(), tops.sgmv_reference(
            *args_t, 0.5).numpy(), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-4,
                               rtol=1e-4)


# ---------------------------------------------------------------------------
# sgmv_rank_bucketed vs JAX (test_kernels_bucketed.py:35-92)
# ---------------------------------------------------------------------------


def _two_bucket_setup(seed=3, T=29, d=128, do=256):
    """3 adapters in 2 buckets (ranks 8, 64): compact per-bucket banks."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, d)).astype(np.float32)
    banks = [((rng.standard_normal((n, d, r)) * 0.1).astype(np.float32),
              (rng.standard_normal((n, r, do)) * 0.1).astype(np.float32))
             for n, r in ((2, 8), (1, 64))]
    aid = rng.integers(0, 3, T).astype(np.int32)
    bucket = np.array([0, 1, 0], np.int32)
    local = np.array([0, 0, 1], np.int32)
    return x, banks, aid, bucket, local


@pytest.mark.parametrize("case", ["compact-16", "compact-8", "compact-1",
                                  "full_banks", "single_bucket",
                                  "empty_bucket", "scaling"])
def test_rank_bucketed_matches_jax(case):
    x, banks, aid, bucket, local = _two_bucket_setup()
    kw = dict(adapter_local=local, block_t=16, scaling=1.0)
    if case.startswith("compact"):
        kw["block_t"] = int(case.split("-")[1])
    elif case == "full_banks":          # adapter_local=None: global rows
        rng = np.random.default_rng(2)
        banks = [((rng.standard_normal((3, 128, r)) * 0.1).astype(
            np.float32), (rng.standard_normal((3, r, 256)) * 0.1).astype(
            np.float32)) for r in (8, 64)]
        kw["adapter_local"] = None
    elif case == "single_bucket":       # degenerates to sgmv
        rng = np.random.default_rng(5)
        x = rng.standard_normal((17, 64)).astype(np.float32)
        banks = [((rng.standard_normal((2, 64, 16)) * 0.1).astype(
            np.float32), (rng.standard_normal((2, 16, 128)) * 0.1).astype(
            np.float32))]
        aid = rng.integers(0, 2, 17).astype(np.int32)
        bucket = np.zeros(2, np.int32)
        kw["adapter_local"] = np.arange(2, dtype=np.int32)
    elif case == "empty_bucket":        # only the rank-64 adapter
        aid = np.full_like(aid, 1)
    else:
        kw["scaling"] = 2.0
    loc = kw.pop("adapter_local")
    yj = jops.sgmv_rank_bucketed(
        jnp.asarray(x), [tuple(map(jnp.asarray, b)) for b in banks],
        jnp.asarray(aid), jnp.asarray(bucket),
        adapter_local=None if loc is None else jnp.asarray(loc),
        interpret=True, **kw)
    yt = tops.sgmv_rank_bucketed(
        _t(x), [tuple(map(_t, b)) for b in banks], torch.from_numpy(aid),
        torch.from_numpy(bucket),
        adapter_local=None if loc is None else torch.from_numpy(loc), **kw)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-4,
                               rtol=1e-4)
    if case == "single_bucket":
        assert torch.equal(yt, tops.sgmv(_t(x), *map(_t, banks[0]),
                                         torch.from_numpy(aid)))


# ---------------------------------------------------------------------------
# the port's own bit-identity pairs
# ---------------------------------------------------------------------------

FUSED_SHAPES = [            # test_kernels_fused.py:22-28
    (7, 128, 8, 128, 2, 8),
    (63, 512, 64, 256, 5, 16),
    (16, 128, 128, 1024, 3, 4),
    (1, 128, 8, 128, 1, 8),
    (48, 384, 32, 384, 6, 1),
]


@pytest.mark.parametrize("T,d,r,do,Na,bt", FUSED_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sgmv_equals_sgmv_fused_bitwise(T, d, r, do, Na, bt, dtype):
    x, A, B, aid = _inputs(T, d, r, do, Na, T * 7 + d)
    args = (_t(x, dtype), _t(A, dtype), _t(B, dtype), torch.from_numpy(aid))
    assert torch.equal(tops.sgmv(*args, block_t=bt),
                       tops.sgmv_fused(*args, block_t=bt))


def _three_bucket_setup(seed=3, T=29, d=128, do=256):
    """test_kernels_fused.py's mixed setup: ranks 8/16/64, 5 adapters."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, d)).astype(np.float32)
    members = [[0, 2], [3], [1, 4]]
    banks = [((rng.standard_normal((len(m), d, r)) * 0.1).astype(np.float32),
              (rng.standard_normal((len(m), r, do)) * 0.1).astype(np.float32))
             for m, r in zip(members, (8, 16, 64))]
    bucket, local = np.zeros(5, np.int32), np.zeros(5, np.int32)
    for b, mem in enumerate(members):
        for j, a in enumerate(mem):
            bucket[a], local[a] = b, j
    aid = rng.integers(0, 5, T).astype(np.int32)
    return x, banks, aid, bucket, local


@pytest.mark.parametrize("block_t", [16, 8, 1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bucketed_fused_equals_host_loop_bitwise(block_t, dtype):
    x, banks, aid, bucket, local = _three_bucket_setup()
    tb = [(_t(A, dtype), _t(B, dtype)) for A, B in banks]
    ta, tbk, tl = (torch.from_numpy(a) for a in (aid, bucket, local))
    y_host = tops.sgmv_rank_bucketed(_t(x, dtype), tb, ta, tbk,
                                     adapter_local=tl, block_t=block_t)
    y_dev = tops.sgmv_bucketed_fused(_t(x, dtype), tb, ta, tbk, tl,
                                     block_t=block_t)
    assert torch.equal(y_host, y_dev)


# ---------------------------------------------------------------------------
# apply_bank_sgmv on bridged banks with nonzero B (test_bank_modes.py:145)
# ---------------------------------------------------------------------------

ADAPTERS = {"a-r8": 8, "b-r64": 64, "c-r8": 8}


@pytest.fixture(scope="module")
def banks():
    """JAX banks in both layouts with nonzero A and B, and their bridged
    port copies."""
    cfg = get_smoke_config("llama-7b-paper")
    rng = np.random.default_rng(5)
    L, d = cfg.n_layers, cfg.d_model
    weights = {aid: {t: {"A": (rng.standard_normal((L, d, r)) * 0.2
                               ).astype(np.float32),
                         "B": (rng.standard_normal((L, r, d)) * 0.2
                               ).astype(np.float32)}
                     for t in cfg.lora.targets}
               for aid, r in ADAPTERS.items()}
    out = {}
    for mode in ("padded", "bucketed"):
        jb = jax_build_bank(cfg, ADAPTERS, jax.random.PRNGKey(3), mode=mode)
        for aid, w in weights.items():
            jb = jb.set_adapter(aid, jax.tree.map(jnp.asarray, w))
        opt = {k: None if getattr(jb, k) is None else
               np.asarray(getattr(jb, k))
               for k in ("adapter_bucket", "adapter_local")}
        tb = bridge.bank_from_numpy(cfg, dict(
            mode=jb.mode, adapter_ids=jb.adapter_ids, ranks=jb.ranks,
            data=jax.tree.map(np.asarray, jb.data),
            bucket_ranks=jb.bucket_ranks, bucket_counts=jb.bucket_counts,
            **opt), device="cpu")
        out[mode] = (jb, tb)
    return cfg, out


@pytest.mark.parametrize("mode", ["padded", "bucketed"])
@pytest.mark.parametrize("fused", [True, False])
def test_apply_bank_sgmv_matches_jax(banks, mode, fused):
    cfg, out = banks
    jb, tb = out[mode]
    T = 12
    x = np.random.default_rng(4).standard_normal((T, cfg.d_model)).astype(
        np.float32)
    aid = np.array([0, 1, 2] * (T // 3), np.int32)
    yj = jax_apply_bank_sgmv(jnp.asarray(x), jb, "q", 1, jnp.asarray(aid),
                             scaling=0.5, interpret=True, fused=fused)
    yt = apply_bank_sgmv(_t(x), tb, "q", 1, torch.from_numpy(aid),
                         scaling=0.5, fused=fused)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-4,
                               rtol=1e-4)
    assert np.abs(yt.numpy()).max() > 1e-2          # the delta is live
    other = apply_bank_sgmv(_t(x), tb, "q", 1, torch.from_numpy(aid),
                            scaling=0.5, fused=not fused)
    assert torch.equal(yt, other)                   # fused == unfused


def test_apply_bank_sgmv_layouts_agree(banks):
    """Padded and bucketed banks hold the same adapters: the same delta."""
    cfg, out = banks
    x = _t(np.random.default_rng(6).standard_normal((9, cfg.d_model)))
    aid = torch.tensor([2, 0, 1] * 3, dtype=torch.int32)
    for name in cfg.lora.targets:
        yp = apply_bank_sgmv(x, out["padded"][1], name, 0, aid, fused=False)
        yb = apply_bank_sgmv(x, out["bucketed"][1], name, 0, aid,
                             fused=False)
        np.testing.assert_allclose(yp.numpy(), yb.numpy(), atol=1e-5,
                                   rtol=1e-5)


# ---------------------------------------------------------------------------
# wrapper rules, and the kernels on a card
# ---------------------------------------------------------------------------


def test_unfused_wrappers_on_cpu_use_plain_versions_and_count_nothing():
    x, A, B, _ = _inputs(16, 128, 8, 256, 2, 0)
    xt = torch.zeros((40, 128))
    xt[:16] = _t(x)
    ba = torch.tensor([1, 0], dtype=torch.int32)
    n1, n2 = tsgmv.sgmv_shrink.launches, tsgmv.sgmv_expand.launches
    h = tsgmv.sgmv_shrink(xt, _t(A), ba, block_t=16)
    assert torch.equal(h, tsgmv.sgmv_shrink_blocks_ref(xt, _t(A), ba))
    y = tsgmv.sgmv_expand(h, _t(B), ba, block_t=16, block_o=128)
    assert torch.equal(y, tsgmv.sgmv_expand_blocks_ref(h, _t(B), ba))
    assert torch.equal(y, tsgmv.sgmv_fused_blocks_ref(xt, _t(A), _t(B), ba))
    assert y.shape == (40, 256) and not y[32:].any()
    assert (tsgmv.sgmv_shrink.launches, tsgmv.sgmv_expand.launches) == \
        (n1, n2)


def test_unfused_wrappers_refuse_non_cuda_devices():
    x = torch.empty((32, 128), device="meta")
    A = torch.empty((2, 128, 8), device="meta")
    h = torch.empty((32, 8), device="meta")
    B = torch.empty((2, 8, 128), device="meta")
    ba = torch.empty((2,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tsgmv.sgmv_shrink(x, A, ba)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tsgmv.sgmv_expand(h, B, ba)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_unfused_pair_and_flash_match_plain_versions(dtype):
    """On the card: B3a, B3b and B5 against their plain versions, and the
    unfused pair bit for bit equal to B1 (runs only where a card is)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev, tol = torch.device("cuda"), TOL[dtype]
    x, A, B, aid = _inputs(63, 512, 64, 2560, 5, 1)
    xt, At, Bt = (_t(a, dtype).to(dev) for a in (x, A, B))
    dest, ba = tops.prepare_segments(torch.from_numpy(aid).to(dev), 5, 16)
    x_pad = tops.scatter_rows(xt, dest, tops.padded_len(63, 5, 16))
    n = x_pad.shape[0] // 16 * 16
    h = tsgmv.sgmv_shrink(x_pad, At, ba)
    y = tsgmv.sgmv_expand(h, Bt, ba)
    torch.cuda.synchronize()
    for got, want in ((h, tsgmv.sgmv_shrink_blocks_ref(x_pad, At, ba)),
                      (y, tsgmv.sgmv_expand_blocks_ref(h, Bt, ba))):
        torch.testing.assert_close(got[:n].float(), want[:n].float(),
                                   atol=tol, rtol=tol)
    assert torch.equal(y[:n], tsgmv.sgmv_fused_blocks(x_pad, At, Bt, ba)[:n])
    q, k, v = (torch.randn((2, 100, 4, 128), generator=torch.Generator(
        ).manual_seed(s)).to(dev, TDT[dtype]).transpose(1, 2)
        for s in range(3))
    for causal, bq, bk in ((True, 128, 128), (True, 32, 64), (False, 64, 32)):
        o = tflash.flash_mha(q, k, v, causal=causal, block_q=bq, block_k=bk)
        torch.testing.assert_close(
            o.float(), tflash.flash_mha_plain(q, k, v, causal=causal).float(),
            atol=tol, rtol=tol)
