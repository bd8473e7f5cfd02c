"""PyTorch port, the split multibank pair B4a/B4b (``sgmv_multibank_shrink``
/ ``sgmv_multibank_expand``) that a tensor-parallel engine runs on each
rank's d slice: the plain versions against the JAX package's Pallas
kernels (interpret mode) at the shard shapes of tp = 1, 2 and 4, the sum
over shards against the unsharded delta, and the port's bit-for-bit
promise that at one rank B4a then B4b is B2.

Tolerances: fp32 1e-5 (JAX against the port: other sum orders; the sum
over shards: the d-sum reassociated); the zero columns and the
bit-identity pairs exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.sgmv import sgmv_multibank_expand as jax_expand
from repro.kernels.sgmv import sgmv_multibank_shrink as jax_shrink
from repro_torch.kernels import ops as tops
from repro_torch.kernels import sgmv as tsgmv

BT = 16
D, D_OUT = 256, 384
# bucket ranks; bucket 1 (rank 16) holds an adapter that no token uses
RANKS = (8, 16, 32, 128)
ADAPTER_BUCKET = np.array([0, 1, 2, 3, 0, 3], np.int32)
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _setup(seed=0, T=45):
    """Numpy inputs of one bucketed call, laid out as the engine lays them
    out: (x_pad, A banks, B banks, block_bucket, block_row, whole rows)."""
    rng = np.random.default_rng(seed)
    Na = len(ADAPTER_BUCKET)
    local = np.zeros(Na, np.int32)
    for a in range(Na):
        local[a] = np.sum(ADAPTER_BUCKET[:a] == ADAPTER_BUCKET[a])
    counts = np.bincount(ADAPTER_BUCKET, minlength=len(RANKS))
    A = [(rng.standard_normal((n, D, r)) * 0.1).astype(np.float32)
         for n, r in zip(counts, RANKS)]
    B = [(rng.standard_normal((n, r, D_OUT)) * 0.1).astype(np.float32)
         for n, r in zip(counts, RANKS)]
    aid = rng.choice([0, 2, 3, 4, 5], T).astype(np.int32)   # never adapter 1
    dest, ba = (np.array(v) for v in jops.prepare_segments_bucketed(
        jnp.asarray(aid), jnp.asarray(ADAPTER_BUCKET), Na, len(RANKS), BT))
    x = rng.standard_normal((T, D)).astype(np.float32)
    x_pad = np.zeros((jops.padded_len(T, Na, BT), D), np.float32)
    x_pad[dest] = x
    bkt, row = ADAPTER_BUCKET[ba], local[ba]
    assert 1 not in bkt[np.unique(dest // BT)]      # the bucket is empty
    n = x_pad.shape[0] // BT * BT
    return x_pad, A, B, bkt, row, n


def _t(a, dtype="float32"):
    return torch.from_numpy(np.array(a)).to(TDT[dtype])


def _shard(a, s, tp, axis):
    w = a.shape[axis] // tp
    return np.take(a, np.arange(s * w, (s + 1) * w), axis=axis)


@pytest.fixture(scope="module")
def setup():
    return _setup()


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_shard_shrink_matches_pallas(setup, tp):
    """Each rank's B4a plain version on its d/tp slice equals the Pallas
    shrink on the same slice; columns above a block's rank are exactly
    0."""
    x_pad, A, _, bkt, row, n = setup
    for s in range(tp):
        xs = _shard(x_pad, s, tp, 1)
        As = [_shard(a, s, tp, 1) for a in A]
        hj = np.asarray(jax_shrink(jnp.asarray(xs),
                                   tuple(jnp.asarray(a) for a in As),
                                   jnp.asarray(bkt), jnp.asarray(row),
                                   block_t=BT, interpret=True))
        ht = tsgmv.sgmv_multibank_shrink(_t(xs), [_t(a) for a in As],
                                         _t(bkt), _t(row), block_t=BT)
        assert ht.shape == (x_pad.shape[0], max(RANKS))
        np.testing.assert_allclose(ht[:n].numpy(), hj[:n], atol=1e-5,
                                   rtol=1e-5)
        r_blk = np.repeat(np.asarray(RANKS)[bkt], BT)[:n]
        above = np.arange(max(RANKS))[None, :] >= r_blk[:, None]
        assert np.all(ht[:n].numpy()[above] == 0.0)
        assert np.all(hj[:n][above] == 0.0)


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_shard_expand_matches_pallas(setup, tp):
    """Each rank's B4b plain version on its d_out/tp columns equals the
    Pallas expand on the same columns."""
    x_pad, A, B, bkt, row, n = setup
    h = tsgmv.sgmv_multibank_shrink_blocks_ref(
        _t(x_pad), [_t(a) for a in A], _t(bkt), _t(row), block_t=BT)
    for s in range(tp):
        Bs = [_shard(b, s, tp, 2) for b in B]
        yj = np.asarray(jax_expand(jnp.asarray(h.numpy()),
                                   tuple(jnp.asarray(b) for b in Bs),
                                   jnp.asarray(bkt), jnp.asarray(row),
                                   block_t=BT, interpret=True))
        yt = tsgmv.sgmv_multibank_expand(h, [_t(b) for b in Bs], _t(bkt),
                                         _t(row), block_t=BT)
        assert yt.shape == (x_pad.shape[0], D_OUT // tp)
        np.testing.assert_allclose(yt[:n].numpy(), yj[:n], atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("tp", [2, 4])
def test_summed_shards_give_the_unsharded_delta(setup, tp):
    """The tp ranks' shrinks summed (the all-reduce), each rank's expand on
    its d_out slice, put side by side: the unsharded B2 output."""
    x_pad, A, B, bkt, row, n = setup
    bb, br = _t(bkt), _t(row)
    h = sum(tsgmv.sgmv_multibank_shrink(
        _t(_shard(x_pad, s, tp, 1)), [_t(_shard(a, s, tp, 1)) for a in A],
        bb, br, block_t=BT) for s in range(tp))
    y = torch.cat([tsgmv.sgmv_multibank_expand(
        h, [_t(_shard(b, s, tp, 2)) for b in B], bb, br, block_t=BT)
        for s in range(tp)], dim=1)
    want = tsgmv.sgmv_multibank_blocks_ref(
        _t(x_pad), [(_t(a), _t(b)) for a, b in zip(A, B)], bb, br,
        block_t=BT)
    np.testing.assert_allclose(y[:n].numpy(), want[:n].numpy(), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_one_rank_pair_is_b2_bit_for_bit(setup, dtype):
    x_pad, A, B, bkt, row, _ = setup
    xt = _t(x_pad, dtype)
    At, Bt = [_t(a, dtype) for a in A], [_t(b, dtype) for b in B]
    bb, br = _t(bkt), _t(row)
    h = tsgmv.sgmv_multibank_shrink(xt, At, bb, br, block_t=BT)
    assert h.dtype == TDT[dtype]
    y = tsgmv.sgmv_multibank_expand(h, Bt, bb, br, block_t=BT)
    assert torch.equal(y, tsgmv.sgmv_multibank_blocks_ref(
        xt, list(zip(At, Bt)), bb, br, block_t=BT))


def test_cpu_tensors_take_the_plain_versions_without_launches(setup):
    x_pad, A, B, bkt, row, _ = setup
    n_a = tsgmv.sgmv_multibank_shrink.launches
    n_b = tsgmv.sgmv_multibank_expand.launches
    h = tsgmv.sgmv_multibank_shrink(_t(x_pad), [_t(a) for a in A], _t(bkt),
                                    _t(row))
    tsgmv.sgmv_multibank_expand(h, [_t(b) for b in B], _t(bkt), _t(row))
    assert tsgmv.sgmv_multibank_shrink.launches == n_a
    assert tsgmv.sgmv_multibank_expand.launches == n_b


def test_split_wrappers_refuse_non_cuda_devices():
    x = torch.empty((32, 128), device="meta")
    A = torch.empty((2, 128, 8), device="meta")
    h = torch.empty((32, 8), device="meta")
    B = torch.empty((2, 8, 128), device="meta")
    idx = torch.empty((2,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tsgmv.sgmv_multibank_shrink(x, [A], idx, idx)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tsgmv.sgmv_multibank_expand(h, [B], idx, idx)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_split_pair_matches_plain_and_b2(setup, dtype):
    """On the card: B4a (into memory that held NaN) and B4b against their
    plain versions at a tp = 2 shard, and at one rank B4a then B4b equal
    to the B2 kernel bit for bit (runs only where a card is)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    x_pad, A, B, bkt, row, n = setup
    dev, tol = torch.device("cuda"), {"float32": 1e-4, "bfloat16": 5e-2}
    bb, br = _t(bkt).to(dev), _t(row).to(dev)
    xs = _t(_shard(x_pad, 1, 2, 1), dtype).to(dev)
    As = [_t(_shard(a, 1, 2, 1), dtype).to(dev) for a in A]
    poison = torch.full((x_pad.shape[0], max(RANKS)), float("nan"),
                        dtype=TDT[dtype], device=dev)
    ptr = poison.data_ptr()
    del poison
    h = tsgmv.sgmv_multibank_shrink(xs, As, bb, br)
    assert h.data_ptr() == ptr           # the launch wrote over the NaN
    want = tsgmv.sgmv_multibank_shrink_blocks_ref(xs, As, bb, br)
    torch.testing.assert_close(h[:n].float(), want[:n].float(),
                               atol=tol[dtype], rtol=tol[dtype])
    Bs = [_t(_shard(b, 1, 2, 2), dtype).to(dev) for b in B]
    y = tsgmv.sgmv_multibank_expand(h, Bs, bb, br, block_o=64)
    torch.testing.assert_close(
        y[:n].float(),
        tsgmv.sgmv_multibank_expand_blocks_ref(h, Bs, bb, br)[:n].float(),
        atol=tol[dtype], rtol=tol[dtype])
    xt = _t(x_pad, dtype).to(dev)
    At = [_t(a, dtype).to(dev) for a in A]
    Bt = [_t(b, dtype).to(dev) for b in B]
    pair = tsgmv.sgmv_multibank_expand(
        tsgmv.sgmv_multibank_shrink(xt, At, bb, br), Bt, bb, br)
    assert torch.equal(pair[:n], tsgmv.sgmv_multibank_blocks(
        xt, list(zip(At, Bt)), bb, br)[:n])
