"""Wrapper of the hand-written Hopper flash-attention kernel B5
(``csrc/flash.cu``) and its plain-torch version.

``flash_mha`` replaces the JAX package's Pallas ``kernels/flash.py:
flash_mha``: multi-head attention (H == Kv) over (B, H, S, hd), online
softmax in fp32, kv blocks wholly above the causal diagonal skipped. The
causal mask is top-left aligned (query i sees keys j <= i), as the
Pallas kernel's is; for Sq == Sk that is ordinary causal attention, for
Sq != Sk it differs from the JAX oracle ``flash_mha_ref``, whose mask is
``tril(k=Sk-Sq)``.

Two kernels serve it, both on the tensor cores with tiles of their own
(``kernel_tile``): in bf16, p rounded to bf16 as the operand of p.v and
the scale applied to the fp32 score; in fp32, q scaled before the
product and both products as 3xTF32 (each operand split into two TF32
halves, three TF32 products summed in fp32). ``csrc/flash.cu`` states
the contract. Both need 16-byte aligned rows of q, k and v.

On a CPU tensor the wrapper computes its plain version; on a CUDA tensor
it launches its kernel or raises. On every device it refuses an input
that requires grad while grad mode is on (``build.refuse_autograd``: the
kernel has no backward). ``flash_mha.launches`` counts kernel launches;
``kept_pairs`` the (query, key) pairs its mask keeps, 4 hd FLOPs each.

``flash_mha_op`` is the same call as an operator of its own,
``torch.ops.repro_torch.flash_mha``: the model calls it, so that a
dispatch mode sees B5 by name, and on ``meta`` tensors it gives its
output's shape without a launch (the dry-run, ``launch/dryrun.py``).
"""
from __future__ import annotations

import ctypes

import torch

from .build import launch as _launch
from .build import refuse_autograd

NEG_INF = -1e30                          # the Pallas kernel's sentinel
MAX_TILE = 128                           # block_q, block_k and hd
BF16_TILE = (64, 64)                     # the bf16 kernel's (q, kv) tile
F32_ROWS, F32_KEYS, F32_WIDE_KEYS = 64, 64, 32   # the fp32 kernel's
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ROW_ALIGN = {torch.float32: 4, torch.bfloat16: 8}   # elements in 16 B
_CARD = "cuda"                           # the device type it runs on


def kernel_tile(dtype, hd: int):
    """The (q rows, keys) tile the kernel of ``dtype`` runs at head dim
    ``hd``: 64 x 64 in bf16; in fp32 64 x 64 where hd pads to 32 or 64
    and 64 x 32 where it pads to 128."""
    if dtype == torch.bfloat16:
        return BF16_TILE
    return F32_ROWS, F32_WIDE_KEYS if hd > 64 else F32_KEYS


def kept_pairs(Sq: int, Sk: int, causal: bool) -> int:
    """The (query, key) pairs of one (batch row, head) that the mask keeps:
    all Sq x Sk non-causal, the min(i + 1, Sk) keys of query i under the
    top-left causal mask."""
    if not causal:
        return Sq * Sk
    n = min(Sq, Sk)
    return n * (n + 1) // 2 + (Sq - n) * Sk


def _default_scale(hd: int, scale):
    return scale if scale is not None else 1.0 / (hd ** 0.5)


def flash_mha_plain(q, k, v, *, causal: bool = True, scale=None):
    """Plain version of B5: the same function with the whole score matrix
    materialized. q: (B, H, Sq, hd); k, v: (B, H, Sk, hd). Scores in fp32
    from q scaled in fp32; masked scores take no part in the softmax (the
    kernel gives them weight 0); a row's sum is floored at 1e-30 as the
    kernel's is. Returns (B, H, Sq, hd) in q's type."""
    Sq, hd = q.shape[2], q.shape[3]
    Sk = k.shape[2]
    qf = q.float() * _default_scale(hd, scale)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, k.float())
    valid = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        valid = torch.arange(Sq, device=q.device)[:, None] >= \
            torch.arange(Sk, device=q.device)[None, :]
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.float()) / l.clamp_min(1e-30)
    return o.to(q.dtype)


def _check(q, k, v, block_q, block_k):
    if q.device.type != _CARD:
        raise ValueError(f"flash_mha runs on CUDA or CPU tensors, got "
                         f"{q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q dtype {q.dtype}: the kernel takes float32 or "
                        "bfloat16")
    B, H, Sq, hd = q.shape
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name} must be {q.dtype} on {q.device}, got "
                             f"{t.dtype} on {t.device}")
        if t.dim() != 4 or t.shape[:2] != (B, H) or t.shape[3] != hd:
            raise ValueError(f"{name} {tuple(t.shape)} does not fit q "
                             f"{tuple(q.shape)}: MHA needs (B, H, Sk, hd)")
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name} needs a unit stride on its last dim")
    if not 1 <= hd <= MAX_TILE:
        raise ValueError(f"head dim {hd} outside 1..{MAX_TILE}")
    if k.shape[2] < 1:
        raise ValueError("flash_mha needs at least one key")
    for name, b in (("block_q", block_q), ("block_k", block_k)):
        if not 1 <= b <= MAX_TILE:
            raise ValueError(f"{name}={b} outside 1..{MAX_TILE}")
    # 16-byte cp.async loads: every row of q, k and v starts aligned
    per16 = _ROW_ALIGN[q.dtype]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16 or any(s % per16 for s in t.stride()[:3]):
            raise ValueError(
                f"{name}: the {str(q.dtype)[6:]} kernel needs 16-byte "
                f"aligned rows (data_ptr % 16 == 0, strides[:3] multiples "
                f"of {per16}), got data_ptr % 16 = {t.data_ptr() % 16}, "
                f"strides {tuple(t.stride())}")


def flash_mha(q, k, v, *, causal: bool = True, scale=None,
              block_q: int = 128, block_k: int = 128):
    """B5. q: (B, H, Sq, hd); k, v: (B, H, Sk, hd), any strides with a
    unit stride on hd (a (B, S, H, hd) tensor's ``transpose(1, 2)`` is
    read in place); hd at most 128. ``block_q`` and ``block_k`` (each
    1..128) are the JAX signature's and are validated only: each kernel
    runs its own tiles (``kernel_tile``). Both kernels need 16-byte
    aligned rows (the data pointer, and the strides over (B, H, S)
    multiples of 4 in fp32, 8 in bf16); the wrapper raises otherwise.
    Returns (B, H, Sq, hd) in q's type; on CUDA its memory is laid out
    (B, Sq, H, hd), so ``out.transpose(1, 2)`` is contiguous."""
    refuse_autograd("flash_mha", q, k, v)
    B, H, Sq, hd = q.shape
    Sk = k.shape[2]
    scale = _default_scale(hd, scale)
    if q.device.type == "cpu":
        return flash_mha_plain(q, k, v, causal=causal, scale=scale)
    _check(q, k, v, block_q, block_k)
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    _launch("flash_mha_launch", q.device, _DTYPE_CODE[q.dtype], q.data_ptr(),
            k.data_ptr(), v.data_ptr(), out.data_ptr(), strides, B, H, Sq,
            Sk, hd, int(causal), float(scale))
    flash_mha.launches += 1
    return out


flash_mha.launches = 0


def flash_mha_op(q, k, v, *, causal: bool = True):
    """``flash_mha(q, k, v, causal=causal)`` through the operator
    ``torch.ops.repro_torch.flash_mha``, refused under autograd as the
    wrapper is."""
    refuse_autograd("flash_mha", q, k, v)
    return _flash_mha_op(q, k, v, causal)


@torch.library.custom_op(
    "repro_torch::flash_mha", mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, bool causal) -> Tensor")
def _flash_mha_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool) -> torch.Tensor:
    return flash_mha(q, k, v, causal=causal)


@_flash_mha_op.register_fake
def _flash_mha_shape(q, k, v, causal):
    B, H, Sq, hd = q.shape
    return q.new_empty((B, Sq, H, hd)).transpose(1, 2)
