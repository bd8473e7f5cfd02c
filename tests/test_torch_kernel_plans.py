"""PyTorch port, the plans of the redesigned kernels: B1's shrink split
over a thread-block cluster (shared by B2, B3a and B4a) and B5's bf16
and fp32 tensor-core numerics, checked without a card.

* ``shrink_split(d, dtype)`` is the one place that decides the cluster
  size C; every wrapper of the shared shrink passes its value to the
  library (a fake library call records what the wrapper hands over).
* torch emulations of the kernels' own summation orders are held against
  the JAX package's Pallas kernels (interpret mode) on the same numpy
  inputs. Tolerances: the SGMV emulation 1e-4 in fp32 and 5e-2 in bf16
  (``tests/test_torch_kernels.py``'s, the JAX suite's own); the B5
  emulation 3e-2 in bf16, the JAX flash suite's own
  (``test_kernels_flash.py``): rounding p to bf16 as the operand of p.v
  moves an output by at most 2^-9 of the weighted sum of |v|, well
  inside it.
* B5's fp32 kernel's 3xTF32 arithmetic (``cvt.rna`` rounding on the
  bits, its kv tiles in order) emulated in torch and held against the
  Pallas kernel in fp32 and the plain version at 1e-4, the card's fp32
  tolerance: 3xTF32 keeps about fp32's own accuracy (the dropped small
  x small term is below 2^-22 of a product).
* B5's wrapper refuses, before any launch, a head dim over 128 and, for
  either kernel, rows that are not 16-byte aligned.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.flash import flash_mha as jax_flash_mha
from repro.kernels.sgmv import sgmv_fused_blocks as jax_fused_blocks
from repro.kernels.sgmv import sgmv_shrink as jax_shrink
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.kernels import flash as tflash
from repro_torch.kernels import sgmv as tsgmv
from repro_torch.lora.adapter import _target_in_dim

TOL = {"float32": 1e-4, "bfloat16": 5e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
SHAPES = [              # tests/test_torch_kernels.py's (T, d, r, do, Na, bt)
    (7, 128, 8, 128, 2, 8),
    (63, 512, 64, 256, 5, 16),
    (16, 128, 128, 1024, 3, 4),
    (1, 128, 8, 128, 1, 8),
    (48, 384, 32, 384, 6, 1),
]


def _np(y):
    if isinstance(y, torch.Tensor):
        return y.float().numpy()
    return np.asarray(y.astype(jnp.float32))


def _both(a, dtype):
    return jnp.asarray(a).astype(JDT[dtype]), torch.from_numpy(
        np.array(a)).to(TDT[dtype])


# ---------------------------------------------------------------------------
# shrink_split: one pure function of (d, dtype)
# ---------------------------------------------------------------------------


def _port_widths():
    """Every d the port's shrink runs: each registered config and its
    smoke config at tp = 1, 2 and 4 (LoRA's A spans d_model or the o
    target's heads, or a rank's share of either), and the widths of the
    kernel tests' SHAPES."""
    widths = {_target_in_dim(cfg, t) // tp
              for arch in ARCH_IDS
              for cfg in (get_config(arch), get_smoke_config(arch))
              for t in cfg.lora.targets for tp in (1, 2, 4)}
    return sorted(widths | {d for _, d, *_ in SHAPES})


@pytest.mark.parametrize("d", _port_widths())
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_shrink_split_covers_every_width(d, dtype):
    split = tsgmv.shrink_split(d, dtype)
    assert split in (4, 8, 16)
    assert all(tsgmv.shrink_split(d, dtype) == split for _ in range(3))
    ds = -(-d // split)
    assert (split - 1) * ds < d          # every block's slice is nonempty


def test_shrink_split_of_the_full_model():
    """llama-7b-paper's widths at tp = 1, 2 and 4 (at 4096 the card ran
    B1's decode call fastest at 16)."""
    got = {d: tsgmv.shrink_split(d, torch.bfloat16)
           for d in (4096, 2048, 1024)}
    assert got == {4096: 16, 2048: 16, 1024: 8}


def test_shrink_split_of_the_moe_models():
    """deepseek-v2-lite-16b's d 2048 (128-row slices) and llama4-scout's
    5120 (320-row slices, not a multiple of 128) both take 16."""
    got = {d: tsgmv.shrink_split(d, torch.bfloat16) for d in (2048, 5120)}
    assert got == {2048: 16, 5120: 16}
    assert -(-5120 // 16) == 320


def test_shrink_split_refuses_what_no_kernel_takes():
    with pytest.raises(ValueError):
        tsgmv.shrink_split(0, torch.bfloat16)
    with pytest.raises(ValueError):
        tsgmv.shrink_split(128, torch.float16)


# ---------------------------------------------------------------------------
# every wrapper of the shared shrink takes C from shrink_split
# ---------------------------------------------------------------------------


@pytest.fixture
def fake_card(monkeypatch):
    """Meta tensors stand in for CUDA ones; the library call records its
    arguments; ``shrink_split`` answers 16 and records its arguments (the
    real answer at these widths is 4, so a 16 can only come from it)."""
    launches, splits = [], []

    def split(d, dtype):
        splits.append((d, dtype))
        return 16

    monkeypatch.setattr(tsgmv, "_CARD", "meta")
    monkeypatch.setattr(tsgmv, "_launch",
                        lambda name, device, *args: launches.append(
                            (name, device, args)))
    monkeypatch.setattr(tsgmv, "shrink_split", split)
    for name in ("sgmv_fused_blocks", "sgmv_multibank_blocks",
                 "sgmv_shrink", "sgmv_expand", "sgmv_multibank_shrink",
                 "sgmv_multibank_expand"):
        fn = getattr(tsgmv, name)
        monkeypatch.setattr(fn, "launches", fn.launches)
    return launches, splits


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def _call(kid, dtype):
    """(wrapper call, library function) of B1, B2, B3a or B4a on a
    3-block layout at d = 256."""
    x, ba = _meta(48, 256, dtype=dtype), _meta(3, dtype=torch.int32)
    A, B = _meta(2, 256, 16, dtype=dtype), _meta(2, 16, 64, dtype=dtype)
    banks = [(_meta(1, 256, 8, dtype=dtype), _meta(1, 8, 64, dtype=dtype)),
             (A, B)]
    return {
        "B1": (lambda: tsgmv.sgmv_fused_blocks(x, A, B, ba),
               "sgmv_fused_blocks_launch"),
        "B2": (lambda: tsgmv.sgmv_multibank_blocks(x, banks, ba, ba),
               "sgmv_multibank_blocks_launch"),
        "B3a": (lambda: tsgmv.sgmv_shrink(x, A, ba), "sgmv_shrink_launch"),
        "B4a": (lambda: tsgmv.sgmv_multibank_shrink(
            x, [a for a, _ in banks], ba, ba), "sgmv_multibank_shrink_launch"),
    }[kid]


@pytest.mark.parametrize("kid", ["B1", "B2", "B3a", "B4a"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrapper_takes_its_split_from_the_helper(fake_card, kid, dtype):
    launches, splits = fake_card
    call, fn_name = _call(kid, dtype)
    call()
    (name, device, args), = launches
    assert name == fn_name and device.type == "meta"
    assert args[0] == (0 if dtype == torch.float32 else 1)   # dtype code
    assert args[1] == 16                                      # the split
    assert splits == [(256, dtype)]


def test_expand_wrappers_take_no_split(fake_card):
    launches, splits = fake_card
    h, ba = _meta(48, 16), _meta(3, dtype=torch.int32)
    tsgmv.sgmv_expand(h, _meta(2, 16, 64), ba)
    tsgmv.sgmv_multibank_expand(h, [_meta(1, 8, 64), _meta(2, 16, 64)], ba,
                                ba)
    assert [n for n, _, _ in launches] == ["sgmv_expand_launch",
                                           "sgmv_multibank_expand_launch"]
    assert splits == []


# ---------------------------------------------------------------------------
# the shrink's order, emulated in torch, against the Pallas kernels
# ---------------------------------------------------------------------------


def split_shrink(x_pad, A, block_adapter, block_t, split):
    """h as the cluster kernels sum it: each whole block's x_blk @ A[aid]
    as ``split`` slice partials over d (fp32), added in rank order, then
    rounded to x's type. Rows past the last whole block are zero."""
    T_pad, d = x_pad.shape
    nb = T_pad // block_t
    n = nb * block_t
    xb = x_pad[:n].reshape(nb, block_t, d).float()
    W = A[block_adapter[:nb].long()].float()
    ds = -(-d // split)
    total = torch.zeros((nb, block_t, A.shape[-1]))
    for q in range(split):
        lo, hi = min(d, q * ds), min(d, (q + 1) * ds)
        total = total + torch.bmm(xb[..., lo:hi], W[:, lo:hi])
    h = x_pad.new_zeros((T_pad, A.shape[-1]))
    h[:n] = total.to(x_pad.dtype).reshape(n, -1)
    return h


def _shrink_case(T, d, r, do, Na, bt, dtype):
    rng = np.random.default_rng(T * 7 + d)
    x = rng.standard_normal((T, d)).astype(np.float32)
    A = (rng.standard_normal((Na, d, r)) * 0.05).astype(np.float32)
    B = (rng.standard_normal((Na, r, do)) * 0.05).astype(np.float32)
    aid = rng.integers(0, Na, T).astype(np.int32)
    dest, ba = (np.array(v) for v in
                jops.prepare_segments(jnp.asarray(aid), Na, bt))
    xp = np.zeros((jops.padded_len(T, Na, bt), d), np.float32)
    xp[dest] = x
    return dest, ba, [_both(v, dtype) for v in (xp, A, B)]


@pytest.mark.parametrize("T,d,r,do,Na,bt", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_shrink_matches_pallas_shrink(T, d, r, do, Na, bt, dtype):
    dest, ba, ((xj, xt), (Aj, At), _) = _shrink_case(T, d, r, do, Na, bt,
                                                     dtype)
    hj = jax_shrink(xj, Aj, jnp.asarray(ba), block_t=bt, interpret=True)
    ht = split_shrink(xt, At, torch.from_numpy(ba), bt,
                      tsgmv.shrink_split(d, TDT[dtype]))
    assert ht.dtype == TDT[dtype]
    np.testing.assert_allclose(_np(ht)[dest], _np(hj)[dest],
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("T,d,r,do,Na,bt", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_shrink_then_expand_matches_pallas_fused(T, d, r, do, Na, bt,
                                                       dtype):
    dest, ba, ((xj, xt), (Aj, At), (Bj, Bt)) = _shrink_case(
        T, d, r, do, Na, bt, dtype)
    yj = jax_fused_blocks(xj, Aj, Bj, jnp.asarray(ba), block_t=bt,
                          interpret=True)
    bat = torch.from_numpy(ba)
    h = split_shrink(xt, At, bat, bt, tsgmv.shrink_split(d, TDT[dtype]))
    yt = tsgmv.sgmv_expand_blocks_ref(h, Bt, bat, block_t=bt)
    np.testing.assert_allclose(_np(yt)[dest], _np(yj)[dest],
                               atol=TOL[dtype], rtol=TOL[dtype])


# ---------------------------------------------------------------------------
# B5's bf16 numerics, emulated in torch, against the Pallas kernel
# ---------------------------------------------------------------------------


def flash_bf16_emulation(q, k, v, *, causal=True, scale=None):
    """The bf16 kernel's arithmetic: kv tiles of 64 keys in order; s =
    (q . k) * scale in fp32; running max from the -1e30 sentinel; masked
    scores weigh 0; l sums the fp32 p; p rounded to bf16 as the operand
    of p.v; o = acc / max(l, 1e-30)."""
    B, H, Sq, hd = q.shape
    Sk = k.shape[2]
    scale = scale if scale is not None else 1.0 / hd ** 0.5
    qf, kf, vf = q.float(), k.float(), v.float()
    m = torch.full((B, H, Sq, 1), tflash.NEG_INF)
    l = torch.zeros((B, H, Sq, 1))
    acc = torch.zeros((B, H, Sq, hd))
    qpos = torch.arange(Sq)[:, None]
    for k0 in range(0, Sk, tflash.BF16_TILE[1]):
        kt = kf[:, :, k0:k0 + tflash.BF16_TILE[1]]
        vt = vf[:, :, k0:k0 + tflash.BF16_TILE[1]]
        kpos = torch.arange(k0, k0 + kt.shape[2])[None, :]
        valid = qpos >= kpos if causal else torch.ones_like(qpos >= kpos)
        s = torch.where(valid, (qf @ kt.transpose(-1, -2)) * scale,
                        tflash.NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.where(valid, torch.exp(s - m_new), 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + p.to(torch.bfloat16).float() @ vt
        m = m_new
    return (acc / l.clamp_min(1e-30)).to(q.dtype)


FLASH_CASES = [          # (B, H, Sq, Sk, hd): test_kernels_flash.py's + 2
    (1, 2, 64, 64, 32),
    (2, 4, 100, 100, 64),
    (1, 1, 128, 256, 32),
    (2, 2, 33, 33, 16),
    (1, 2, 130, 70, 128),  # Sq > Sk, three q tiles, a partial kv tile
    (1, 2, 150, 150, 128),  # the diagonal tile holds 22 live rows
]


def _flash_inputs(B, H, Sq, Sk, hd, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, H, Sq, hd), (B, H, Sk, hd), (B, H, Sk, hd))]


@pytest.mark.parametrize("B,H,Sq,Sk,hd", FLASH_CASES)
@pytest.mark.parametrize("causal", [True, False])
def test_bf16_flash_emulation_matches_pallas(B, H, Sq, Sk, hd, causal):
    """Causal Sq != Sk against the Pallas kernel itself, whose mask is
    top-left aligned like the port's."""
    q, k, v = _flash_inputs(B, H, Sq, Sk, hd, B * 100 + Sq + causal)
    oj = jax_flash_mha(*(jnp.asarray(a).astype(jnp.bfloat16)
                         for a in (q, k, v)), causal=causal, interpret=True)
    ot = flash_bf16_emulation(*(torch.from_numpy(a).to(torch.bfloat16)
                                for a in (q, k, v)), causal=causal)
    assert ot.dtype == torch.bfloat16 and ot.shape == (B, H, Sq, hd)
    np.testing.assert_allclose(_np(ot), _np(oj), atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("B,H,Sq,Sk,hd", FLASH_CASES)
def test_bf16_flash_emulation_within_the_card_tolerance_of_plain(B, H, Sq,
                                                                 Sk, hd):
    """``chip_smoke.py`` holds the bf16 kernel against the plain version
    (p in fp32) at 5e-2: the emulated departure stays inside it."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _flash_inputs(B, H, Sq, Sk, hd, Sq + hd))
    o = flash_bf16_emulation(q, k, v, causal=True)
    ref = tflash.flash_mha_plain(q, k, v, causal=True)
    np.testing.assert_allclose(_np(o), _np(ref), atol=5e-2, rtol=5e-2)


# ---------------------------------------------------------------------------
# B5's fp32 numerics (3xTF32), emulated in torch, against the Pallas kernel
# ---------------------------------------------------------------------------


def tf32_rna(x):
    """``cvt.rna.tf32.f32`` on the bits: the 13 low mantissa bits rounded
    off to nearest, ties away from zero (a half-ulp add on the magnitude,
    then truncation; the carry may step the exponent)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def mm_3xtf32(a, b):
    """a @ b as the fp32 kernel's mma: each operand split into big =
    tf32(x) and small = tf32(x - big), the small terms first, a_small
    b_small dropped (the sum order inside an mma is the tensor core's)."""
    a_big, b_big = tf32_rna(a), tf32_rna(b)
    a_small, b_small = tf32_rna(a - a_big), tf32_rna(b - b_big)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def flash_fp32_emulation(q, k, v, *, causal=True, scale=None):
    """The fp32 kernel's arithmetic: q scaled in fp32 first; kv tiles of
    ``kernel_tile(float32, hd)`` keys in order; s = q_scaled k^T and p v
    as 3xTF32 products; running max from the -1e30 sentinel; masked
    scores weigh 0; l sums the fp32 p; o = acc / max(l, 1e-30)."""
    B, H, Sq, hd = q.shape
    Sk = k.shape[2]
    scale = scale if scale is not None else 1.0 / hd ** 0.5
    keys = tflash.kernel_tile(torch.float32, hd)[1]
    qs = q.float() * scale
    kf, vf = k.float(), v.float()
    m = torch.full((B, H, Sq, 1), tflash.NEG_INF)
    l = torch.zeros((B, H, Sq, 1))
    acc = torch.zeros((B, H, Sq, hd))
    qpos = torch.arange(Sq)[:, None]
    for k0 in range(0, Sk, keys):
        kt, vt = kf[:, :, k0:k0 + keys], vf[:, :, k0:k0 + keys]
        kpos = torch.arange(k0, k0 + kt.shape[2])[None, :]
        valid = qpos >= kpos if causal else torch.ones_like(qpos >= kpos)
        s = torch.where(valid, mm_3xtf32(qs, kt.transpose(-1, -2)),
                        tflash.NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.where(valid, torch.exp(s - m_new), 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + mm_3xtf32(p, vt)
        m = m_new
    return acc / l.clamp_min(1e-30)


def test_tf32_rna_rounds_to_nearest_ties_away():
    one = 1 << 13                      # a tf32 ulp at exponent 0, in bits
    base = torch.tensor([1.0], dtype=torch.float32).view(torch.int32)
    cases = {0x0FFF: 0, 0x1000: one, 0x1001: one, 0x17FF: one,
             0x1FFF: one, 0x3000: 2 * one}     # 0x3000: 1.5 ulps, a tie
    for low, up in cases.items():
        for sign in (1, -1):
            x = (base + low).view(torch.float32) * sign
            want = (base + up).view(torch.float32) * sign
            assert tf32_rna(x).item() == want.item(), (hex(low), sign)
    # the carry steps the exponent: the largest mantissa rounds to 2.0
    top = (base + 0x7FFFFF).view(torch.float32)
    assert tf32_rna(top).item() == 2.0
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        4096).astype(np.float32))
    big = tf32_rna(x)
    assert (big.view(torch.int32) & 0x1FFF == 0).all()
    assert ((x - big).abs() <= x.abs() * 2.0 ** -11).all()
    split = big + tf32_rna(x - big)
    assert ((x - split).abs() <= x.abs() * 2.0 ** -21).all()


FP32_FLASH_CASES = [      # (B, H, Sq, Sk, hd): 64-key tiles at hd 64,
    (1, 2, 100, 100, 64),     # 32-key tiles at 112 and 128
    (2, 1, 70, 130, 64),      # Sq < Sk, a ragged last tile
    (1, 2, 97, 45, 112),      # Sq > Sk, hd padded to 128
    (1, 1, 130, 70, 128),     # three q tiles, a partial kv tile
]


@pytest.mark.parametrize("B,H,Sq,Sk,hd", FP32_FLASH_CASES)
@pytest.mark.parametrize("causal", [True, False])
def test_fp32_flash_emulation_matches_pallas_and_plain(B, H, Sq, Sk, hd,
                                                       causal):
    """The emulated 3xTF32 kernel against the Pallas kernel (fp32,
    interpret mode; top-left causal mask like the port's) and against
    ``flash_mha_plain``, both at the fp32 tolerance ``chip_smoke.py``
    holds the kernel to (1e-4)."""
    q, k, v = _flash_inputs(B, H, Sq, Sk, hd, B * 1000 + Sq + Sk + causal)
    oj = jax_flash_mha(*(jnp.asarray(a) for a in (q, k, v)), causal=causal,
                       interpret=True)
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    ot = flash_fp32_emulation(qt, kt, vt, causal=causal)
    assert ot.dtype == torch.float32 and ot.shape == (B, H, Sq, hd)
    np.testing.assert_allclose(_np(ot), _np(oj), atol=1e-4, rtol=1e-4)
    ref = tflash.flash_mha_plain(qt, kt, vt, causal=causal)
    np.testing.assert_allclose(_np(ot), _np(ref), atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# B5's refusals, before any launch
# ---------------------------------------------------------------------------


@pytest.fixture
def fake_flash_card(monkeypatch):
    launches = []
    monkeypatch.setattr(tflash, "_CARD", "meta")
    monkeypatch.setattr(tflash, "_launch",
                        lambda name, device, *args: launches.append(args))
    monkeypatch.setattr(tflash.flash_mha, "launches",
                        tflash.flash_mha.launches)
    return launches


def _bshd(B, S, H, hd, dtype, pad=0):
    """A (B, S, H, hd) activation read as (B, H, S, hd); ``pad`` extra
    elements a head row shift every row start."""
    t = torch.empty((B, S, H, hd + pad), dtype=dtype, device="meta")
    return t[..., :hd].transpose(1, 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_refuses_a_head_dim_over_128(fake_flash_card, dtype):
    q = _bshd(1, 8, 2, 144, dtype)
    with pytest.raises(ValueError, match="head dim"):
        tflash.flash_mha(q, q, q)
    assert fake_flash_card == []


@pytest.mark.parametrize("which,dtype", [
    pytest.param(w, dt, id=w + ("" if dt == torch.bfloat16 else "-float32"))
    for dt in (torch.bfloat16, torch.float32) for w in "qkv"])
def test_bf16_flash_refuses_misaligned_rows(fake_flash_card, which, dtype):
    """Rows 8 bytes off 16-byte alignment break 16-byte cp.async in both
    kernels: a row stride of 132 bf16 (264 bytes) or 130 fp32 (520)."""
    pad = 4 if dtype == torch.bfloat16 else 2
    ok = _bshd(1, 8, 2, 128, dtype)
    bad = _bshd(1, 8, 2, 128, dtype, pad=pad)
    args = {n: bad if n == which else ok for n in "qkv"}
    with pytest.raises(ValueError, match="16-byte aligned"):
        tflash.flash_mha(args["q"], args["k"], args["v"])
    assert fake_flash_card == []


def test_fp32_flash_takes_what_bf16_refuses(fake_flash_card):
    """A row stride of 132 elements is 528 bytes in fp32, 16-byte
    aligned: the fp32 kernel launches where the bf16 one (264 bytes)
    refuses. Each launch carries its dtype code and no tile: each kernel
    runs its own (``kernel_tile``), whatever block_q and block_k say."""
    rows = _bshd(1, 40, 2, 128, torch.float32, pad=4)
    tflash.flash_mha(rows, rows, rows, block_q=32, block_k=16)
    bad16 = _bshd(1, 40, 2, 128, torch.bfloat16, pad=4)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tflash.flash_mha(bad16, bad16, bad16)
    ok = _bshd(1, 40, 2, 128, torch.bfloat16)
    tflash.flash_mha(ok, ok, ok)
    (a32, a16) = fake_flash_card
    assert a32[0] == 0 and a16[0] == 1
    # B, H, Sq, Sk, hd, causal, scale: the tiles are not arguments
    assert a32[6:11] == (1, 2, 40, 40, 128) and len(a32) == 13
    assert tflash.kernel_tile(torch.bfloat16, 128) == (64, 64)
    assert tflash.kernel_tile(torch.float32, 64) == (64, 64)
    assert tflash.kernel_tile(torch.float32, 112) == (64, 32)
    assert tflash.kernel_tile(torch.float32, 128) == (64, 32)


def test_flash_block_sizes_are_validated_for_both_types(fake_flash_card):
    ok = _bshd(1, 8, 2, 128, torch.bfloat16)
    with pytest.raises(ValueError, match="block_q"):
        tflash.flash_mha(ok, ok, ok, block_q=256)
    assert fake_flash_card == []
