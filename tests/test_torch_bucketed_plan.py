"""PyTorch port, the rank-bucketed path's block plan and live rows, checked
without a card.

* ``repro_torch.kernels.tune.block_plan`` gives the JAX package's
  ``tune.block_plan(...).block_t`` on every bank signature of a grid: T
  from 1 to 5000, d 2048 / 4096 / 5120, the engine's five-bucket bank and
  the kernel tests' banks.
* ``sgmv_bucketed_fused(block_t=None)`` lays tokens out exactly as the
  JAX ``prepare_segments_bucketed`` at the JAX plan (dest, block bucket,
  block row, T_pad), and its delta matches the JAX
  ``sgmv_bucketed_fused(block_t=None)`` (Pallas in interpret mode) at
  ``tests/test_torch_kernels.py``'s fp32 tolerance, 1e-4.
* On the plain versions, fp32 and bf16: B2 at the plan's block_t equals
  the host loop ``sgmv_rank_bucketed`` at 16 and B1 on the zero-padded
  bank bit for bit; the plain B2 takes any block_t (against the Pallas
  kernel at 24, 32, 48 and 64).
* ``ops.live_rows`` equals a numpy count, spare blocks count 0, and the
  plain versions zero the rows past a block's count.
* The refusals: B2 outside 1..16, 32, 64; every other kernel above 16.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import tune as jtune
from repro_torch.kernels import ops as tops
from repro_torch.kernels import sgmv as tsgmv
from repro_torch.kernels import tune as ttune

ENGINE_BANK = ((8, 16, 32, 64, 128), (1, 1, 1, 1, 1))   # chip_smoke's
BANKS = [
    ENGINE_BANK,
    ((8, 16, 64), (2, 1, 2)),      # test_torch_kernels.py's _mixed_setup
    ((8, 16, 64), (1, 1, 1)),      # test_torch_engine.py's smoke engine
    ((8, 64), (3, 3)),             # the global-row bucketed test
]


@pytest.mark.parametrize("T", [1, 8, 64, 200, 1000, 2000, 5000])
@pytest.mark.parametrize("d", [2048, 4096, 5120])
@pytest.mark.parametrize("bank", BANKS, ids=lambda b: "r" + "-".join(
    map(str, b[0])) + "_n" + "-".join(map(str, b[1])))
def test_block_plan_matches_jax(T, d, bank):
    ranks, counts = bank
    want = jtune.block_plan(T, d, d, ranks, counts).block_t
    got = ttune.block_plan(T, d, d, ranks, counts)
    assert got == want
    assert got in ttune.SUPPORTED_BLOCK_T


def test_block_plan_of_the_engine_prefill_group():
    """chip_smoke.py's 2 x 1000-token group runs B2 at 64, its decode at
    16."""
    assert ttune.block_plan(2000, 4096, 4096, *ENGINE_BANK) == 64
    assert ttune.block_plan(8, 4096, 4096, *ENGINE_BANK) == 16


@pytest.mark.parametrize("bt", [0, 17, 24, 48, 128])
def test_check_block_t_refuses_what_b2_does_not_take(bt):
    with pytest.raises(ValueError, match="block_t"):
        ttune.check_block_t(bt)


# ---------------------------------------------------------------------------
# the dispatcher at block_t=None: the reference's layout and delta
# ---------------------------------------------------------------------------


def _case(kind, seed, d=128, do=128):
    """numpy (x, banks, token_adapter, adapter_bucket, adapter_local):
    ``rows`` — the engine's layout, every batch row its own adapter, two
    rows of 400 tokens over buckets of ranks 8/16/64 (the plan picks 64);
    ``decode`` — 5 rows of one token; ``mixed`` — 5 adapters in 3
    buckets (ranks 8/16/64, three adapters at rank 64), 700 tokens in a
    ragged mix (the plan picks 32)."""
    rng = np.random.default_rng(seed)
    ranks = (8, 16, 64)
    if kind == "mixed":
        members = [[0], [3], [1, 2, 4]]
        T = 700
        aid = rng.integers(0, 5, T).astype(np.int32)
    else:
        members = [[0], [1], [2]]
        T, rows = (800, 2) if kind == "rows" else (5, 5)
        aid = np.repeat(np.arange(rows, dtype=np.int32), T // rows)
    banks = [((rng.standard_normal((len(m), d, r)) * 0.1).astype(np.float32),
              (rng.standard_normal((len(m), r, do)) * 0.1).astype(np.float32))
             for m, r in zip(members, ranks)]
    if kind == "mixed":
        bucket = np.zeros(5, np.int32)
        local = np.zeros(5, np.int32)
        for b, mem in enumerate(members):
            for j, a in enumerate(mem):
                bucket[a], local[a] = b, j
    else:
        n = aid.max() + 1
        bucket = rng.integers(0, 3, n).astype(np.int32)
        local = np.zeros(n, np.int32)
    x = rng.standard_normal((T, d)).astype(np.float32)
    return x, banks, aid, bucket, local


def _torch(x, banks, aid, bucket, local, dtype=torch.float32):
    return (torch.from_numpy(x).to(dtype),
            [(torch.from_numpy(A).to(dtype), torch.from_numpy(B).to(dtype))
             for A, B in banks],
            torch.from_numpy(aid), torch.from_numpy(bucket),
            torch.from_numpy(local))


def _jax_plan(x, banks):
    return jtune.block_plan(x.shape[0], x.shape[1], banks[0][1].shape[-1],
                            tuple(A.shape[-1] for A, _ in banks),
                            tuple(A.shape[0] for A, _ in banks)).block_t


@pytest.fixture
def b2_calls(monkeypatch):
    """Records the arguments the dispatcher hands B2's wrapper."""
    calls = []
    real = tops.sgmv_multibank_blocks

    def rec(x_pad, banks, block_bucket, block_row, **kw):
        calls.append((x_pad, block_bucket, block_row, kw))
        return real(x_pad, banks, block_bucket, block_row, **kw)

    monkeypatch.setattr(tops, "sgmv_multibank_blocks", rec)
    return calls


@pytest.mark.parametrize("kind,plan", [("rows", 64), ("decode", 16),
                                       ("mixed", 32)])
def test_default_layout_is_the_reference_layout(b2_calls, kind, plan):
    x, banks, aid, bucket, local = _case(kind, seed=1)
    jbt = _jax_plan(x, banks)
    assert jbt == plan
    jdest, jba = (np.array(v) for v in jops.prepare_segments_bucketed(
        jnp.asarray(aid), jnp.asarray(bucket), bucket.shape[0], len(banks),
        jbt))
    tops.sgmv_bucketed_fused(*_torch(x, banks, aid, bucket, local))
    (x_pad, bb, br, kw), = b2_calls
    assert kw["block_t"] == jbt
    assert x_pad.shape[0] == jops.padded_len(x.shape[0], bucket.shape[0],
                                             jbt)
    np.testing.assert_array_equal(bb.numpy(), bucket[jba])
    np.testing.assert_array_equal(br.numpy(), local[jba])
    # the port's layout helper at the plan's block_t, field by field
    dest, bb2, br2, _ = tops.bucketed_layout(
        *_torch(x, banks, aid, bucket, local)[:1],
        torch.from_numpy(aid), torch.from_numpy(bucket),
        torch.from_numpy(local), len(banks), jbt)
    np.testing.assert_array_equal(dest.numpy(), jdest)
    np.testing.assert_array_equal(bb2.numpy(), bucket[jba])
    np.testing.assert_array_equal(br2.numpy(), local[jba])


@pytest.mark.parametrize("kind", ["rows", "decode", "mixed"])
@pytest.mark.parametrize("scaling", [1.0, 0.5])
def test_default_delta_matches_jax(kind, scaling):
    x, banks, aid, bucket, local = _case(kind, seed=2)
    yj = jops.sgmv_bucketed_fused(
        jnp.asarray(x), [tuple(map(jnp.asarray, bk)) for bk in banks],
        jnp.asarray(aid), jnp.asarray(bucket), jnp.asarray(local),
        scaling=scaling, interpret=True)
    yt = tops.sgmv_bucketed_fused(*_torch(x, banks, aid, bucket, local),
                                  scaling=scaling)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-4,
                               rtol=1e-4)


def _zero_padded(banks, bucket, local):
    max_r = max(A.shape[-1] for A, _ in banks)
    Na = bucket.shape[0]
    A0, B0 = banks[0]
    Ap = A0.new_zeros((Na, A0.shape[1], max_r))
    Bp = B0.new_zeros((Na, max_r, B0.shape[-1]))
    for a in range(Na):
        A, B = banks[int(bucket[a])]
        Ap[a, :, :A.shape[-1]] = A[int(local[a])]
        Bp[a, :B.shape[1]] = B[int(local[a])]
    return Ap, Bp


@pytest.mark.parametrize("kind", ["rows", "decode", "mixed"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plan_block_t_gives_the_host_loop_and_padded_bits(kind, dtype):
    """The port's promise at the plan's block_t (64, 16, 32 here), on the
    plain versions: bucketed (B2) == host loop (B3a/B3b at 16) == padded
    (B1 at 16), bit for bit."""
    x, banks, tok, bucket, local = _torch(*_case(kind, seed=3), dtype=dtype)
    y = tops.sgmv_bucketed_fused(x, banks, tok, bucket, local)
    host = tops.sgmv_rank_bucketed(x, banks, tok, bucket,
                                   adapter_local=local, block_t=16)
    Ap, Bp = _zero_padded(banks, bucket, local)
    padded = tops.sgmv_fused(x, Ap, Bp, tok, block_t=16)
    assert y.abs().max() > 0
    assert torch.equal(y, host)
    assert torch.equal(y, padded)


@pytest.mark.parametrize("block_t", [24, 32, 48, 64])
def test_plain_b2_takes_any_block_t(block_t):
    """The plain B2 against the Pallas kernel (interpret mode) at block
    sizes past 16, whole tiles of 16 or not; fp32 tolerance 1e-4."""
    from repro.kernels.sgmv import sgmv_multibank_blocks as jax_mb
    x, banks, aid, bucket, local = _case("mixed", seed=6)
    dest, ba = (np.array(v) for v in jops.prepare_segments_bucketed(
        jnp.asarray(aid), jnp.asarray(bucket), 5, 3, block_t))
    xp = np.zeros((jops.padded_len(x.shape[0], 5, block_t), x.shape[1]),
                  np.float32)
    xp[dest] = x
    bkt, row = bucket[ba].astype(np.int32), local[ba].astype(np.int32)
    yj = jax_mb(jnp.asarray(xp), tuple(tuple(map(jnp.asarray, bk))
                                       for bk in banks),
                jnp.asarray(bkt), jnp.asarray(row), block_t=block_t,
                interpret=True)
    yt = tsgmv.sgmv_multibank_blocks_ref(
        torch.from_numpy(xp), _torch(x, banks, aid, bucket, local)[1],
        torch.from_numpy(bkt), torch.from_numpy(row), block_t=block_t)
    np.testing.assert_allclose(yt.numpy()[dest], np.asarray(yj)[dest],
                               atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# live rows
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["rows", "decode", "mixed"])
@pytest.mark.parametrize("block_t", [1, 8, 16, 32, 64])
def test_live_rows_equals_a_numpy_count(kind, block_t):
    x, banks, aid, bucket, local = _case(kind, seed=4)
    dest, bb, _, x_pad = tops.bucketed_layout(
        torch.from_numpy(x), torch.from_numpy(aid), torch.from_numpy(bucket),
        torch.from_numpy(local), len(banks), block_t)
    live = tops.live_rows(dest, x_pad.shape[0], block_t)
    nblocks = x_pad.shape[0] // block_t
    want = np.bincount(dest.numpy() // block_t, minlength=nblocks)[:nblocks]
    assert live.dtype == torch.int32
    np.testing.assert_array_equal(live.numpy(), want)
    # live rows are a prefix of their block; spare blocks hold none
    occupied = np.zeros(x_pad.shape[0], bool)
    occupied[dest.numpy()] = True
    for i in range(nblocks):
        rows = occupied[i * block_t:(i + 1) * block_t]
        assert rows[:want[i]].all() and not rows[want[i]:].any()
    assert want.sum() == x.shape[0]      # every token in a whole block


def _padded_layout(T=45, d=64, r=16, do=48, Na=3, block_t=16, seed=5):
    rng = np.random.default_rng(seed)
    aid = rng.integers(0, Na, T).astype(np.int32)
    x = torch.from_numpy(rng.standard_normal((T, d)).astype(np.float32))
    A = torch.from_numpy(rng.standard_normal((Na, d, r)).astype(np.float32))
    B = torch.from_numpy(rng.standard_normal((Na, r, do)).astype(np.float32))
    dest, ba, x_pad = tops.segment_layout(x, torch.from_numpy(aid), Na,
                                          block_t)
    # rows past the live ones made nonzero: the count alone zeroes them
    x_pad = x_pad + (x_pad == 0).float() * 3.0
    return dest, ba, x_pad, A, B


def test_plain_versions_zero_rows_past_the_live_count():
    dest, ba, x_pad, A, B = _padded_layout()
    live = tops.live_rows(dest, x_pad.shape[0], 16)
    keep = torch.zeros(x_pad.shape[0], dtype=torch.bool)
    keep[dest.long()] = True
    y_full = tsgmv.sgmv_fused_blocks_ref(x_pad, A, B, ba)
    for y in (tsgmv.sgmv_fused_blocks_ref(x_pad, A, B, ba, block_live=live),
              tsgmv.sgmv_multibank_blocks_ref(x_pad, [(A, B)],
                                              torch.zeros_like(ba), ba,
                                              block_live=live)):
        assert torch.equal(y[keep], y_full[keep])
        assert not y[~keep].any() and y_full[~keep].abs().max() > 0
    h_full = tsgmv.sgmv_shrink_blocks_ref(x_pad, A, ba)
    for h in (tsgmv.sgmv_shrink_blocks_ref(x_pad, A, ba, block_live=live),
              tsgmv.sgmv_multibank_shrink_blocks_ref(
                  x_pad, [A], torch.zeros_like(ba), ba, block_live=live)):
        assert torch.equal(h[keep], h_full[keep]) and not h[~keep].any()


# ---------------------------------------------------------------------------
# refusals (meta tensors stand in for CUDA ones; nothing launches)
# ---------------------------------------------------------------------------


@pytest.fixture
def fake_card(monkeypatch):
    launches = []
    monkeypatch.setattr(tsgmv, "_CARD", "meta")
    monkeypatch.setattr(tsgmv, "_launch",
                        lambda name, device, *args: launches.append(
                            (name, args)))
    for name in ("sgmv_fused_blocks", "sgmv_multibank_blocks",
                 "sgmv_shrink", "sgmv_expand", "sgmv_multibank_shrink",
                 "sgmv_multibank_expand"):
        fn = getattr(tsgmv, name)
        monkeypatch.setattr(fn, "launches", fn.launches)
    return launches


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def _calls(bt):
    """Every SGMV wrapper on a 3-block layout at block_t ``bt``."""
    x, idx = _meta(3 * bt, 256), _meta(3, dtype=torch.int32)
    A, B = _meta(2, 256, 16), _meta(2, 16, 64)
    h = _meta(3 * bt, 16)
    return {
        "B1": lambda: tsgmv.sgmv_fused_blocks(x, A, B, idx, block_t=bt),
        "B2": lambda: tsgmv.sgmv_multibank_blocks(x, [(A, B)], idx, idx,
                                                  block_t=bt),
        "B3a": lambda: tsgmv.sgmv_shrink(x, A, idx, block_t=bt),
        "B3b": lambda: tsgmv.sgmv_expand(h, B, idx, block_t=bt),
        "B4a": lambda: tsgmv.sgmv_multibank_shrink(x, [A], idx, idx,
                                                   block_t=bt),
        "B4b": lambda: tsgmv.sgmv_multibank_expand(h, [B], idx, idx,
                                                   block_t=bt),
    }


@pytest.mark.parametrize("bt", [32, 64])
def test_b2_takes_large_blocks_the_others_refuse(fake_card, bt):
    calls = _calls(bt)
    calls["B2"]()
    (name, args), = fake_card
    assert name == "sgmv_multibank_blocks_launch"
    assert args[-4:-2] == (3, bt)                 # nblocks, block_t
    for kid in ("B1", "B3a", "B3b", "B4a", "B4b"):
        with pytest.raises(ValueError, match="block_t"):
            calls[kid]()
    assert len(fake_card) == 1


@pytest.mark.parametrize("bt", [17, 48, 128])
def test_b2_refuses_sizes_outside_its_set(fake_card, bt):
    with pytest.raises(ValueError, match="block_t"):
        _calls(bt)["B2"]()
    x = torch.zeros((3 * bt, 8))
    A, B = torch.zeros((1, 8, 4)), torch.zeros((1, 4, 8))
    idx = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="block_t"):   # on the CPU too
        tsgmv.sgmv_multibank_blocks(x, [(A, B)], idx, idx, block_t=bt)
    assert fake_card == []


def test_shrink_wrappers_hand_the_live_counts_over(fake_card):
    """B1, B2, B3a and B4a pass a pointer to the live counts beside the
    block indices; B3b and B4b take none."""
    live = _meta(3, dtype=torch.int32)
    x, idx = _meta(48, 256), _meta(3, dtype=torch.int32)
    A, B = _meta(2, 256, 16), _meta(2, 16, 64)
    tsgmv.sgmv_fused_blocks(x, A, B, idx, block_live=live)
    tsgmv.sgmv_multibank_blocks(x, [(A, B)], idx, idx, block_live=live)
    tsgmv.sgmv_shrink(x, A, idx, block_live=live)
    tsgmv.sgmv_multibank_shrink(x, [A], idx, idx, block_live=live)
    n_args = {name: len(args) for name, args in fake_card}
    assert n_args == {"sgmv_fused_blocks_launch": 13,
                      "sgmv_multibank_blocks_launch": 15,
                      "sgmv_shrink_launch": 11,
                      "sgmv_multibank_shrink_launch": 14}
    with pytest.raises(ValueError, match="block_live"):
        tsgmv.sgmv_shrink(x, A, idx, block_live=_meta(4, dtype=torch.int32))
