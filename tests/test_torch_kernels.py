"""PyTorch port, kernel layer: the segment layout, the plain versions of
the two SGMV kernels (B1 padded, B2 rank-bucketed) and the dispatch
wrappers, each held against the JAX package on the same numpy inputs.
The JAX side runs its Pallas kernels in interpret mode.

Tolerances: integer layouts exact; fp32 deltas atol = rtol = 1e-4 (two
frameworks sum in different orders); bf16 5e-2, the JAX suite's own
(test_kernels_fused.py:40).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.sgmv import sgmv_fused_blocks as jax_fused_blocks
from repro.kernels.sgmv import sgmv_multibank_blocks as jax_multibank_blocks
from repro_torch.kernels import ops as tops
from repro_torch.kernels import sgmv as tsgmv

TOL = {"float32": 1e-4, "bfloat16": 5e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _both(a, dtype="float32"):
    """One numpy array as a JAX array and a torch tensor of one dtype
    (both round fp32 to bf16 to nearest even, so the values agree)."""
    return jnp.asarray(a).astype(JDT[dtype]), torch.from_numpy(
        np.array(a)).to(TDT[dtype])


def _np(y):
    if isinstance(y, torch.Tensor):
        return y.float().numpy()
    return np.asarray(y.astype(jnp.float32))


# ---------------------------------------------------------------------------
# segment layout: dest and block_adapter equal JAX's exactly
# ---------------------------------------------------------------------------

LAYOUTS = [            # (T, Na, block_t, adapters present)
    (7, 2, 8, 2),
    (63, 5, 16, 5),
    (57, 6, 8, 6),
    (48, 6, 1, 6),      # block_t = 1 (BGMV)
    (1, 1, 8, 1),
    (29, 7, 16, 3),     # empty adapters
    (4, 4, 16, 4),      # decode layout: T_pad = 68, not a multiple of 16
    (40, 5, 8, 2),      # ragged, empty adapters, block_t 8
]


@pytest.mark.parametrize("T,Na,bt,present", LAYOUTS)
def test_prepare_segments_matches_jax(T, Na, bt, present):
    rng = np.random.default_rng(T * 31 + Na)
    aid = rng.choice(rng.permutation(Na)[:present], T).astype(np.int32)
    dj, bj = jops.prepare_segments(jnp.asarray(aid), Na, bt)
    dt, btt = tops.prepare_segments(torch.from_numpy(aid), Na, bt)
    np.testing.assert_array_equal(np.asarray(dj), dt.numpy())
    np.testing.assert_array_equal(np.asarray(bj), btt.numpy())
    assert dt.dtype == btt.dtype == torch.int32
    assert btt.shape[0] == tops.padded_len(T, Na, bt) // bt


@pytest.mark.parametrize("T,Na,bt,present", LAYOUTS)
def test_prepare_segments_bucketed_matches_jax(T, Na, bt, present):
    rng = np.random.default_rng(T * 17 + Na)
    aid = rng.choice(rng.permutation(Na)[:present], T).astype(np.int32)
    nb = 3
    bucket = rng.integers(0, nb, Na).astype(np.int32)
    dj, bj = jops.prepare_segments_bucketed(jnp.asarray(aid),
                                            jnp.asarray(bucket), Na, nb, bt)
    dt, btt = tops.prepare_segments_bucketed(torch.from_numpy(aid),
                                             torch.from_numpy(bucket), Na,
                                             nb, bt)
    np.testing.assert_array_equal(np.asarray(dj), dt.numpy())
    np.testing.assert_array_equal(np.asarray(bj), btt.numpy())


# ---------------------------------------------------------------------------
# plain versions of B1 / B2 vs the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

SHAPES = [              # test_kernels_fused.py:22-28
    (7, 128, 8, 128, 2, 8),
    (63, 512, 64, 256, 5, 16),
    (16, 128, 128, 1024, 3, 4),
    (1, 128, 8, 128, 1, 8),
    (48, 384, 32, 384, 6, 1),
]


def _fused_inputs(T, d, r, do, Na, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, d)).astype(np.float32)
    A = (rng.standard_normal((Na, d, r)) * 0.05).astype(np.float32)
    B = (rng.standard_normal((Na, r, do)) * 0.05).astype(np.float32)
    aid = rng.integers(0, Na, T).astype(np.int32)
    return x, A, B, aid


def _x_pad(x, dest, T_pad):
    xp = np.zeros((T_pad, x.shape[1]), np.float32)
    xp[dest] = x
    return xp


@pytest.mark.parametrize("T,d,r,do,Na,bt", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_blocks_ref_matches_pallas(T, d, r, do, Na, bt, dtype):
    x, A, B, aid = _fused_inputs(T, d, r, do, Na, T * 7 + d)
    dest, ba = (np.array(v) for v in
                jops.prepare_segments(jnp.asarray(aid), Na, bt))
    xp = _x_pad(x, dest, jops.padded_len(T, Na, bt))
    (xj, xt), (Aj, At), (Bj, Bt) = (_both(v, dtype) for v in (xp, A, B))
    yj = jax_fused_blocks(xj, Aj, Bj, jnp.asarray(ba), block_t=bt,
                          interpret=True)
    yt = tsgmv.sgmv_fused_blocks_ref(xt, At, Bt, torch.from_numpy(ba),
                                     block_t=bt)
    assert yt.dtype == TDT[dtype] and yt.shape == (xp.shape[0], do)
    np.testing.assert_allclose(_np(yt)[dest], _np(yj)[dest],
                               atol=TOL[dtype], rtol=TOL[dtype])


def _mixed_setup(seed=3, T=29, d=128, do=256):
    """test_kernels_fused.py's _mixed_setup in numpy: 3 buckets (ranks
    8/16/64), 5 adapters, a ragged token mix; per-bucket banks + the
    equivalent max-rank padded bank."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, d)).astype(np.float32)
    ranks = [8, 16, 64]
    members = [[0, 2], [3], [1, 4]]       # bucket -> adapters
    banks = [((rng.standard_normal((len(m), d, r)) * 0.1).astype(np.float32),
              (rng.standard_normal((len(m), r, do)) * 0.1).astype(np.float32))
             for m, r in zip(members, ranks)]
    bucket = np.zeros(5, np.int32)
    local = np.zeros(5, np.int32)
    Apad = np.zeros((5, d, 64), np.float32)
    Bpad = np.zeros((5, 64, do), np.float32)
    for b, mem in enumerate(members):
        for j, a in enumerate(mem):
            bucket[a], local[a] = b, j
            Apad[a, :, :ranks[b]] = banks[b][0][j]
            Bpad[a, :ranks[b]] = banks[b][1][j]
    aid = rng.integers(0, 5, T).astype(np.int32)
    return x, banks, (Apad, Bpad), aid, bucket, local


@pytest.mark.parametrize("block_t", [16, 8, 1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_multibank_blocks_ref_matches_pallas(block_t, dtype):
    x, banks, _, aid, bucket, local = _mixed_setup()
    T, Na = x.shape[0], 5
    dest, ba = (np.array(v) for v in jops.prepare_segments_bucketed(
        jnp.asarray(aid), jnp.asarray(bucket), Na, 3, block_t))
    xj, xt = _both(_x_pad(x, dest, jops.padded_len(T, Na, block_t)), dtype)
    bj = [tuple(_both(m, dtype)[0] for m in bk) for bk in banks]
    bt = [tuple(_both(m, dtype)[1] for m in bk) for bk in banks]
    bkt, row = bucket[ba], local[ba]
    yj = jax_multibank_blocks(xj, tuple(bj), jnp.asarray(bkt),
                              jnp.asarray(row), block_t=block_t,
                              interpret=True)
    yt = tsgmv.sgmv_multibank_blocks_ref(xt, bt, torch.from_numpy(bkt),
                                         torch.from_numpy(row),
                                         block_t=block_t)
    np.testing.assert_allclose(_np(yt)[dest], _np(yj)[dest],
                               atol=TOL[dtype], rtol=TOL[dtype])


# ---------------------------------------------------------------------------
# dispatch wrappers vs JAX's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("T,d,r,do,Na,bt", SHAPES)
def test_sgmv_fused_matches_jax(T, d, r, do, Na, bt):
    scaling = 0.5 if T % 2 else 1.0
    x, A, B, aid = _fused_inputs(T, d, r, do, Na, T + d)
    yj = jops.sgmv_fused(jnp.asarray(x), jnp.asarray(A), jnp.asarray(B),
                         jnp.asarray(aid), scaling=scaling, block_t=bt,
                         interpret=True)
    yt = tops.sgmv_fused(torch.from_numpy(x), torch.from_numpy(A),
                         torch.from_numpy(B), torch.from_numpy(aid),
                         scaling=scaling, block_t=bt)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-4,
                               rtol=1e-4)
    yr = tops.sgmv_reference(torch.from_numpy(x), torch.from_numpy(A),
                             torch.from_numpy(B), torch.from_numpy(aid),
                             scaling)
    np.testing.assert_allclose(yt.numpy(), yr.numpy(), atol=1e-4, rtol=1e-4)


def _torch_banks(banks):
    return [(torch.from_numpy(A), torch.from_numpy(B)) for A, B in banks]


@pytest.mark.parametrize("layout", ["ragged", "decode"])
@pytest.mark.parametrize("scaling", [1.0, 2.0])
def test_sgmv_bucketed_fused_matches_jax(layout, scaling):
    x, banks, _, aid, bucket, local = _mixed_setup()
    if layout == "decode":
        # the engine's decode layout: one row per "adapter", each its own
        # 16-row block holding a single token
        x, aid = x[:5], np.arange(5, dtype=np.int32)
    yj = jops.sgmv_bucketed_fused(
        jnp.asarray(x), [tuple(map(jnp.asarray, bk)) for bk in banks],
        jnp.asarray(aid), jnp.asarray(bucket), jnp.asarray(local),
        scaling=scaling, block_t=16, interpret=True)
    yt = tops.sgmv_bucketed_fused(
        torch.from_numpy(x), _torch_banks(banks), torch.from_numpy(aid),
        torch.from_numpy(bucket), torch.from_numpy(local), scaling=scaling)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-4,
                               rtol=1e-4)


def test_sgmv_bucketed_fused_global_rows():
    """adapter_local=None: every bucket bank indexed by the global id."""
    rng = np.random.default_rng(2)
    banks = [((rng.standard_normal((3, 128, r)) * 0.1).astype(np.float32),
              (rng.standard_normal((3, r, 256)) * 0.1).astype(np.float32))
             for r in (8, 64)]
    bucket = np.array([0, 1, 0], np.int32)
    x = rng.standard_normal((24, 128)).astype(np.float32)
    aid = rng.integers(0, 3, 24).astype(np.int32)
    yj = jops.sgmv_bucketed_fused(
        jnp.asarray(x), [tuple(map(jnp.asarray, bk)) for bk in banks],
        jnp.asarray(aid), jnp.asarray(bucket), block_t=16, interpret=True)
    yt = tops.sgmv_bucketed_fused(torch.from_numpy(x), _torch_banks(banks),
                                  torch.from_numpy(aid),
                                  torch.from_numpy(bucket))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("block_t", [16, 8, 1])
def test_bucketed_fused_equals_padded_fused(block_t):
    """The port's own promise: the bucketed bank set and the equivalent
    zero-padded max-rank bank give the same delta (padding is inert)."""
    x, banks, (Apad, Bpad), aid, bucket, local = _mixed_setup()
    yb = tops.sgmv_bucketed_fused(torch.from_numpy(x), _torch_banks(banks),
                                  torch.from_numpy(aid),
                                  torch.from_numpy(bucket),
                                  torch.from_numpy(local), block_t=block_t)
    yp = tops.sgmv_fused(torch.from_numpy(x), torch.from_numpy(Apad),
                         torch.from_numpy(Bpad), torch.from_numpy(aid),
                         block_t=block_t)
    np.testing.assert_allclose(yb.numpy(), yp.numpy(), atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# wrapper rules: CPU -> plain version; other devices -> kernel or raise
# ---------------------------------------------------------------------------


def test_wrappers_on_cpu_use_plain_version_and_count_nothing():
    x, A, B, aid = _fused_inputs(16, 128, 8, 128, 2, 0)
    xt = torch.from_numpy(_x_pad(x, np.arange(16), 48))
    ba = torch.tensor([0, 1, 0], dtype=torch.int32)
    n1 = tsgmv.sgmv_fused_blocks.launches
    n2 = tsgmv.sgmv_multibank_blocks.launches
    y = tsgmv.sgmv_fused_blocks(xt, torch.from_numpy(A), torch.from_numpy(B),
                                ba)
    ref = tsgmv.sgmv_fused_blocks_ref(xt, torch.from_numpy(A),
                                      torch.from_numpy(B), ba)
    assert torch.equal(y, ref)
    banks = [(torch.from_numpy(A), torch.from_numpy(B))]
    y2 = tsgmv.sgmv_multibank_blocks(xt, banks, torch.zeros_like(ba), ba)
    assert torch.equal(y2, tsgmv.sgmv_multibank_blocks_ref(
        xt, banks, torch.zeros_like(ba), ba))
    assert tsgmv.sgmv_fused_blocks.launches == n1
    assert tsgmv.sgmv_multibank_blocks.launches == n2


def test_wrappers_refuse_non_cuda_devices():
    """A tensor neither on the CPU nor on a card is refused before any
    launch: there is no path that quietly computes elsewhere."""
    x = torch.empty((32, 128), device="meta")
    A = torch.empty((2, 128, 8), device="meta")
    B = torch.empty((2, 8, 128), device="meta")
    ba = torch.empty((2,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tsgmv.sgmv_fused_blocks(x, A, B, ba)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tsgmv.sgmv_multibank_blocks(x, [(A, B)], ba, ba)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernels_match_plain_versions(dtype):
    """On the card: both kernels against their plain versions on the rows
    the layout reads (runs only where a card is present)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    x, banks, (Apad, Bpad), aid, bucket, local = _mixed_setup()
    dev = torch.device("cuda")
    dt = TDT[dtype]
    xt = torch.from_numpy(x).to(dev, dt)
    tb = [(torch.from_numpy(A).to(dev, dt), torch.from_numpy(B).to(dev, dt))
          for A, B in banks]
    yb = tops.sgmv_bucketed_fused(xt, tb, torch.from_numpy(aid).to(dev),
                                  torch.from_numpy(bucket).to(dev),
                                  torch.from_numpy(local).to(dev))
    yp = tops.sgmv_fused(xt, torch.from_numpy(Apad).to(dev, dt),
                         torch.from_numpy(Bpad).to(dev, dt),
                         torch.from_numpy(aid).to(dev))
    torch.cuda.synchronize()
    yr = tops.sgmv_bucketed_fused(xt.cpu(), [(A.cpu(), B.cpu())
                                             for A, B in tb],
                                  torch.from_numpy(aid),
                                  torch.from_numpy(bucket),
                                  torch.from_numpy(local))
    np.testing.assert_allclose(_np(yb.cpu()), _np(yr), atol=TOL[dtype],
                               rtol=TOL[dtype])
    assert torch.equal(yb, yp)      # padding is inert, bit for bit
