"""PyTorch port, the SGMV expand that B3b, B4b, B1 and B2 share, checked
without a card.

* A torch emulation of the bf16 expand's order — an fp32 accumulator from
  +0, the rank's 16-wide k chunks added in order (each chunk's product
  summed in fp32, both operands zero past the rank), the sum rounded to
  bf16 — is held against the JAX package's Pallas ``sgmv_expand`` and
  ``sgmv_multibank_expand`` (interpret mode) on the same numpy inputs, at
  ranks 1..128, block_t 1 and 16 and a ragged d_out. Tolerance 5e-2, the
  JAX suite's own for bf16 (``tests/test_kernels_sgmv.py``).
* In that emulation a zero-padded rank-128 bank gives the same bits as
  the same adapters bucketed at their own ranks: the padded bank's extra
  chunks are exact zeros.
* The expand wrappers hand the library their shapes and never a tile
  derived from ``block_o`` (a fake library call records the arguments).
* The build hashes the shared header ``csrc/ptx.cuh`` with the sources.
* On a card (``cuda`` marker): B3b and B4b against their plain versions
  at ragged shapes.
"""
import ctypes
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.sgmv import sgmv_expand as jax_expand
from repro.kernels.sgmv import sgmv_multibank_expand as jax_mb_expand
from repro_torch.kernels import build as tbuild
from repro_torch.kernels import sgmv as tsgmv

BF16_TOL = 5e-2
K_STEP = 16                        # the mma's k: rank rows a chunk
RANKS = [1, 4, 8, 24, 64, 128]
D_OUT = 200                        # ragged: not a multiple of 8 or 64


def _np(y):
    if isinstance(y, torch.Tensor):
        return y.float().numpy()
    return np.asarray(y.astype(jnp.float32))


def expand_block_emulation(h_blk, b):
    """One token block as the bf16 expand sums it: h_blk (block_t, r) and
    b (r, d_out), both bf16; returns the fp32 sums (block_t, d_out)."""
    r = b.shape[0]
    kp = -(-r // K_STEP) * K_STEP
    h = torch.zeros((h_blk.shape[0], kp))
    w = torch.zeros((kp, b.shape[1]))
    h[:, :r] = h_blk.float()
    w[:r] = b.float()
    acc = torch.zeros((h_blk.shape[0], b.shape[1]))
    for k0 in range(0, kp, K_STEP):
        acc = acc + h[:, k0:k0 + K_STEP] @ w[k0:k0 + K_STEP]
    return acc


def expand_emulation(h_pad, B, block_adapter, block_t):
    """B3b's arithmetic over every whole block: (T_pad, d_out) in h's
    type, rows past the last whole block zero."""
    nb = h_pad.shape[0] // block_t
    out = h_pad.new_zeros((h_pad.shape[0], B.shape[-1]))
    for i in range(nb):
        rows = slice(i * block_t, (i + 1) * block_t)
        out[rows] = expand_block_emulation(
            h_pad[rows, :B.shape[1]], B[int(block_adapter[i])]).to(h_pad.dtype)
    return out


def multibank_expand_emulation(h_pad, B_banks, block_bucket, block_row,
                               block_t):
    """B4b's arithmetic: each whole block reads h[:, :r_b] of its bucket
    b and multiplies it by B_b[row]."""
    nb = h_pad.shape[0] // block_t
    out = h_pad.new_zeros((h_pad.shape[0], B_banks[0].shape[-1]))
    for i in range(nb):
        rows = slice(i * block_t, (i + 1) * block_t)
        b = B_banks[int(block_bucket[i])][int(block_row[i])]
        out[rows] = expand_block_emulation(h_pad[rows, :b.shape[0]],
                                           b).to(h_pad.dtype)
    return out


def _padded_case(r, block_t, seed, T=37, Na=3):
    """bf16 numpy-made (h_pad, B, block_adapter, dest) of a padded bank in
    the engine's segment layout."""
    rng = np.random.default_rng(seed)
    aid = rng.integers(0, Na, T).astype(np.int32)
    dest, ba = (np.array(v) for v in
                jops.prepare_segments(jnp.asarray(aid), Na, block_t))
    h = np.zeros((jops.padded_len(T, Na, block_t), r), np.float32)
    h[dest] = rng.standard_normal((T, r))
    B = (rng.standard_normal((Na, r, D_OUT)) * 0.1).astype(np.float32)
    return h, B, ba, dest


@pytest.mark.parametrize("r", RANKS)
@pytest.mark.parametrize("block_t", [1, 16])
def test_bf16_expand_order_matches_pallas_expand(r, block_t):
    h, B, ba, dest = _padded_case(r, block_t, seed=r * 31 + block_t)
    yj = jax_expand(jnp.asarray(h).astype(jnp.bfloat16),
                    jnp.asarray(B).astype(jnp.bfloat16), jnp.asarray(ba),
                    block_t=block_t, block_o=128, interpret=True)
    yt = expand_emulation(torch.from_numpy(h).to(torch.bfloat16),
                          torch.from_numpy(B).to(torch.bfloat16),
                          torch.from_numpy(ba), block_t)
    assert yt.dtype == torch.bfloat16 and yt.shape == (h.shape[0], D_OUT)
    np.testing.assert_allclose(_np(yt)[dest], _np(yj)[dest], atol=BF16_TOL,
                               rtol=BF16_TOL)


def _bucketed_case(ranks, block_t, seed, T=45):
    """bf16 numpy-made inputs of a bucketed call: one adapter a bucket,
    bucket b at rank ranks[b]; h (T_pad, max_r) with zeros above each
    row's rank, as B4a writes it. Returns (h, B banks, block_bucket,
    block_row, dest)."""
    rng = np.random.default_rng(seed)
    nb = len(ranks)
    aid = rng.integers(0, nb, T).astype(np.int32)
    dest, ba = (np.array(v) for v in jops.prepare_segments_bucketed(
        jnp.asarray(aid), jnp.arange(nb, dtype=jnp.int32), nb, nb, block_t))
    h = np.zeros((jops.padded_len(T, nb, block_t), max(ranks)), np.float32)
    for t, a in zip(dest, aid):
        h[t, :ranks[a]] = rng.standard_normal(ranks[a])
    B = [(rng.standard_normal((1, r, D_OUT)) * 0.1).astype(np.float32)
         for r in ranks]
    return h, B, ba, np.zeros_like(ba), dest


@pytest.mark.parametrize("block_t", [1, 16])
@pytest.mark.parametrize("ranks", [(1, 4, 8), (24, 64, 128),
                                   (8, 16, 32, 64, 128)])
def test_bf16_expand_order_matches_pallas_multibank_expand(ranks, block_t):
    h, B, bkt, row, dest = _bucketed_case(ranks, block_t, seed=len(ranks))
    yj = jax_mb_expand(jnp.asarray(h).astype(jnp.bfloat16),
                       [jnp.asarray(b).astype(jnp.bfloat16) for b in B],
                       jnp.asarray(bkt), jnp.asarray(row), block_t=block_t,
                       block_o=128, interpret=True)
    yt = multibank_expand_emulation(
        torch.from_numpy(h).to(torch.bfloat16),
        [torch.from_numpy(b).to(torch.bfloat16) for b in B],
        torch.from_numpy(bkt), torch.from_numpy(row), block_t)
    np.testing.assert_allclose(_np(yt)[dest], _np(yj)[dest], atol=BF16_TOL,
                               rtol=BF16_TOL)


@pytest.mark.parametrize("block_t", [1, 16])
def test_bf16_expand_padded_bank_gives_bucketed_bits(block_t):
    """The same adapters (ranks 1..128) in a padded bank (rank 128, zero
    rows) and bucketed at their own ranks: the same bits."""
    ranks = RANKS
    h, B, bkt, row, dest = _bucketed_case(ranks, block_t, seed=block_t)
    hb = torch.from_numpy(h).to(torch.bfloat16)
    B_banks = [torch.from_numpy(b).to(torch.bfloat16) for b in B]
    bucketed = multibank_expand_emulation(hb, B_banks, torch.from_numpy(bkt),
                                          torch.from_numpy(row), block_t)
    Bp = torch.zeros((len(ranks), max(ranks), D_OUT), dtype=torch.bfloat16)
    for a, b in enumerate(B_banks):
        Bp[a, :b.shape[1]] = b[0]
    padded = expand_emulation(hb, Bp, torch.from_numpy(bkt), block_t)
    n = h.shape[0] // block_t * block_t
    assert padded[dest].abs().max() > 0          # the delta is live
    assert torch.equal(padded[:n].view(torch.int16),
                       bucketed[:n].view(torch.int16))


# ---------------------------------------------------------------------------
# the expand wrappers' launch arguments (meta tensors, a fake library)
# ---------------------------------------------------------------------------


@pytest.fixture
def fake_card(monkeypatch):
    launches = []
    monkeypatch.setattr(tsgmv, "_CARD", "meta")
    def launch(name, device, *args):     # ctypes arrays as their values
        launches.append((name, tuple(
            tuple(a) if isinstance(a, ctypes.Array) else a for a in args)))

    monkeypatch.setattr(tsgmv, "_launch", launch)
    for fn in (tsgmv.sgmv_expand, tsgmv.sgmv_multibank_expand):
        monkeypatch.setattr(fn, "launches", fn.launches)
    return launches


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_expand_launch_takes_shapes_not_block_o(fake_card, dtype):
    """B3b and B4b at d_out 200 with block_o 64, 128 and the default: the
    library gets the same arguments each time, ending in the shapes
    (nblocks, block_t, rank or max_r, d_out), and no tile."""
    h, ba = _meta(48, 32, dtype=dtype), _meta(3, dtype=torch.int32)
    B = _meta(2, 32, D_OUT, dtype=dtype)
    banks = [_meta(1, 8, D_OUT, dtype=dtype), _meta(2, 32, D_OUT,
                                                    dtype=dtype)]
    for kw in ({"block_o": 64}, {"block_o": 128}, {}):
        tsgmv.sgmv_expand(h, B, ba, **kw)
        tsgmv.sgmv_multibank_expand(h, banks, ba, ba, **kw)
    names = [n for n, _ in fake_card]
    assert names == ["sgmv_expand_launch", "sgmv_multibank_expand_launch"] * 3
    b3b = [args for n, args in fake_card if n == "sgmv_expand_launch"]
    b4b = [args for n, args in fake_card if n != "sgmv_expand_launch"]
    assert all(a == b3b[0] for a in b3b) and all(a == b4b[0] for a in b4b)
    code = 0 if dtype == torch.float32 else 1
    assert b3b[0][0] == code and b3b[0][-4:] == (3, 16, 32, D_OUT)
    assert b4b[0][0] == code and b4b[0][-4:] == (3, 16, 32, D_OUT)
    assert tsgmv.sgmv_expand.launches == 3
    assert tsgmv.sgmv_multibank_expand.launches == 3


def test_expand_wrappers_still_validate_block_o(fake_card):
    h, ba = _meta(48, 32), _meta(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="block_o"):
        tsgmv.sgmv_expand(h, _meta(2, 32, D_OUT), ba, block_o=0)
    with pytest.raises(ValueError, match="block_o"):
        tsgmv.sgmv_multibank_expand(h, [_meta(2, 32, D_OUT)], ba, ba,
                                    block_o=0)
    assert fake_card == []


def test_build_hashes_the_shared_header(tmp_path, monkeypatch):
    """An edit of ``csrc/ptx.cuh`` changes the library's hash, so the
    next first use rebuilds both sources that include it."""
    csrc = tmp_path / "csrc"
    shutil.copytree(tbuild.CSRC, csrc)
    assert (csrc / "ptx.cuh").exists()
    for src in ("sgmv.cu", "flash.cu"):
        assert '#include "ptx.cuh"' in (csrc / src).read_text()
    monkeypatch.setattr(tbuild, "CSRC", csrc)
    before = tbuild.library_path()
    (csrc / "ptx.cuh").write_text((csrc / "ptx.cuh").read_text() + "\n")
    assert tbuild.library_path() != before


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_expand_kernels_match_plain_at_ragged_shapes(dtype):
    """On the card: B3b and B4b against their plain versions at ranks 1..128,
    block_t 1 and 16 and d_out 200 (runs only where a card is)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    tol = {torch.float32: 1e-4, torch.bfloat16: BF16_TOL}[dtype]
    for block_t in (1, 16):
        for r in RANKS:
            h, B, ba, _ = _padded_case(r, block_t, seed=r + block_t)
            ht, Bt = (torch.from_numpy(a).to(dev, dtype) for a in (h, B))
            bat = torch.from_numpy(ba).to(dev)
            n = h.shape[0] // block_t * block_t
            y = tsgmv.sgmv_expand(ht, Bt, bat, block_t=block_t)
            want = tsgmv.sgmv_expand_blocks_ref(ht, Bt, bat, block_t=block_t)
            torch.testing.assert_close(y[:n].float(), want[:n].float(),
                                       atol=tol, rtol=tol)
        h, B, bkt, row, _ = _bucketed_case(RANKS, block_t, seed=block_t)
        ht = torch.from_numpy(h).to(dev, dtype)
        Bt = [torch.from_numpy(b).to(dev, dtype) for b in B]
        bb, br = (torch.from_numpy(a).to(dev) for a in (bkt, row))
        n = h.shape[0] // block_t * block_t
        y = tsgmv.sgmv_multibank_expand(ht, Bt, bb, br, block_t=block_t)
        want = tsgmv.sgmv_multibank_expand_blocks_ref(ht, Bt, bb, br,
                                                      block_t=block_t)
        torch.testing.assert_close(y[:n].float(), want[:n].float(), atol=tol,
                                   rtol=tol)
