"""State-space blocks of the PyTorch port: Mamba2 (the SSD recurrence of
zamba2's hybrid stack) and RWKV-6 "Finch" (data-dependent decay WKV), the
counterparts of the JAX package's ``models/ssm.py``. Both have a
full-sequence form and a single-step decode form with explicit state.

The JAX package runs each recurrence as a ``lax.scan`` over tokens; no
Pallas kernel computes them, and here each is a plain loop over tokens in
torch. The simplifications are the reference's: Mamba2 has no depthwise
conv-4 front; RWKV-6 mixes its token shift with learned per-channel
vectors and keeps the ddlerp LoRA for the decay alone.

Types, as in the reference: the Mamba2 scan runs in fp32 and its state
comes back in the activation type (rounded once a sequence, and at every
decode step); the WKV state stays fp32; the token-shift states hold
activations. Weights are (d_in, d_out), used as ``x @ w``.

Tensor parallel (``tp``): both split by head. A Mamba2 rank holds its
heads' x and z columns of ``w_xz``, its columns of ``w_dt`` and its
entries of ``dt_bias``, ``A_log``, ``D`` and ``ln_y``; ``w_bc`` (shared
by every head) is whole. Its scan runs over its heads only, the gated
norm over the split width is ``rmsnorm_sharded``, and ``w_out`` is
row-parallel, one all-reduce. An RWKV-6 rank holds its heads' columns of
``w_r``, ``w_k``, ``w_v``, ``w_g`` and of the decay (``w0``, ``wa2``),
its rows of ``u``, its channels of ``ln_x`` and its rows of ``w_o``; the
WKV state holds its heads, the token shifts stay full width. The channel
mix splits d_ff (``wk_cm`` by column, ``wv_cm`` by row). The head counts
are read from the weights. The LoRA targets on the receptance, key and
value come back as the rank's columns, and ``o``'s goes into the
rank's columns of the partial sum (``common.row_parallel_out``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .common import (all_reduce_, dense_init, rmsnorm_sharded,
                     row_parallel_out, tp_size)

# ---------------------------------------------------------------------------
# Mamba2 (SSD)
# ---------------------------------------------------------------------------


def mamba_dims(cfg):
    s = cfg.ssm
    inner = s.expand * cfg.d_model
    H = inner // s.head_dim
    return inner, H, s.head_dim, s.d_state


def _param(t):
    return nn.Parameter(t, requires_grad=False)


class Mamba2(nn.Module):
    """ln: (d,); w_xz: (d, 2 inner); w_bc: (d, 2 N); w_dt: (d, H);
    dt_bias, A_log, D: (H,); ln_y: (inner,); w_out: (inner, d)."""

    def __init__(self, cfg, gen: torch.Generator, dtype=torch.float32):
        super().__init__()
        d = cfg.d_model
        inner, H, _, N = mamba_dims(cfg)
        dev = gen.device
        self.ln = _param(torch.ones(d, dtype=dtype, device=dev))
        self.w_xz = _param(dense_init(gen, (d, 2 * inner), dtype=dtype))
        self.w_bc = _param(dense_init(gen, (d, 2 * N), dtype=dtype))
        self.w_dt = _param(dense_init(gen, (d, H), dtype=dtype))
        self.dt_bias = _param(torch.zeros(H, dtype=dtype, device=dev))
        self.A_log = _param(torch.zeros(H, dtype=dtype, device=dev))
        self.D = _param(torch.ones(H, dtype=dtype, device=dev))
        self.ln_y = _param(torch.ones(inner, dtype=dtype, device=dev))
        self.w_out = _param(dense_init(gen, (inner, d), fan_in=inner,
                                       dtype=dtype))


def init_mamba2(cfg, gen: torch.Generator, dtype=torch.float32) -> Mamba2:
    return Mamba2(cfg, gen, dtype)


def mamba2_state(cfg, batch: int, dtype=torch.float32, device="cpu",
                 tp=None):
    """The zero state of one layer: (B, H, hd, N), the rank's H / tp heads
    at tp > 1."""
    _, H, hd, N = mamba_dims(cfg)
    return torch.zeros((batch, H // tp_size(tp), hd, N), dtype=dtype,
                       device=device)


def _mamba_proj(cfg, p: Mamba2, u):
    """u: (B,S,d) -> x (B,S,H,hd), z (B,S,inner), b, c (B,S,N), a (B,S,H),
    dt (B,S,H); H and inner this rank's."""
    H, hd = p.w_dt.shape[1], cfg.ssm.head_dim
    x, z = (u @ p.w_xz).chunk(2, dim=-1)
    b, c = (u @ p.w_bc).chunk(2, dim=-1)
    dt = F.softplus(u @ p.w_dt + p.dt_bias)                  # (B,S,H)
    a = torch.exp(-dt * torch.exp(p.A_log))                  # decay in (0,1)
    return x.reshape(*x.shape[:-1], H, hd), z, b, c, a, dt


def _mamba_out(cfg, p: Mamba2, y, z, x, tp):
    """y: (B,S,H,hd) ssm output; skip, gate and project."""
    B, S = y.shape[:2]
    y = y + p.D[:, None] * x
    y = rmsnorm_sharded(y.reshape(B, S, -1) * F.silu(z), p.ln_y,
                        cfg.rmsnorm_eps, tp)
    return all_reduce_(y @ p.w_out, tp)


def mamba2_full(cfg, p: Mamba2, u, state, tp=None):
    """u: (B,S,d); state: (B,H,hd,N). Returns (out, new_state), the state
    in u's type. The scan runs in fp32: state, inputs and products."""
    x, z, b, c, a, dt = _mamba_proj(cfg, p, u)
    dtx = (x * dt[..., None]).float()                        # (B,S,H,hd)
    b, c, a = b.float(), c.float(), a.float()
    s = state.float()
    ys = []
    for t in range(u.shape[1]):
        s = s * a[:, t, :, None, None] + \
            dtx[:, t, :, :, None] * b[:, t, None, None, :]
        ys.append(torch.einsum("bhdn,bn->bhd", s, c[:, t]))
    y = torch.stack(ys, dim=1).to(u.dtype)                   # (B,S,H,hd)
    return _mamba_out(cfg, p, y, z, x, tp), s.to(u.dtype)


def mamba2_step(cfg, p: Mamba2, u, state, tp=None):
    """u: (B,1,d); state: (B,H,hd,N), any type. As the reference: the
    input's outer product is formed in u's type, the update and the
    readout in fp32, and the new state comes back in u's type."""
    x, z, b, c, a, dt = _mamba_proj(cfg, p, u)
    dtx = x[:, 0] * dt[:, 0, :, None]
    s32 = state.float() * a[:, 0, :, None, None] + \
        (dtx[..., None] * b[:, 0, None, None, :]).float()
    y = torch.einsum("bhdn,bn->bhd", s32, c[:, 0].float())[:, None]
    return _mamba_out(cfg, p, y.to(u.dtype), z, x, tp), s32.to(u.dtype)


# ---------------------------------------------------------------------------
# RWKV-6 (Finch)
# ---------------------------------------------------------------------------

_DECAY_LORA = 64


def rwkv_dims(cfg):
    hd = cfg.ssm.head_dim
    return cfg.d_model // hd, hd


class RWKV6(nn.Module):
    """One RWKV-6 layer: time mix (ln1, mu_*, w_r/k/v/g/o, decay w0,
    wa1/wa2, bonus u, ln_x) and channel mix (ln2, mu_cm, wk_cm, wv_cm)."""

    def __init__(self, cfg, gen: torch.Generator, dtype=torch.float32):
        super().__init__()
        d, ff = cfg.d_model, cfg.d_ff
        H, hd = rwkv_dims(cfg)
        dev = gen.device

        def full(shape, v):
            return _param(torch.full(shape, v, dtype=dtype, device=dev))

        def w(shape, fan_in=None):
            return _param(dense_init(gen, shape, fan_in=fan_in, dtype=dtype))

        self.ln1 = full((d,), 1.0)
        for name in ("mu_r", "mu_k", "mu_v", "mu_g", "mu_w"):
            setattr(self, name, full((d,), 0.5))
        for name in ("w_r", "w_k", "w_v", "w_g", "w_o"):
            setattr(self, name, w((d, d)))
        self.w0 = full((d,), -1.0)                           # decay base
        self.wa1 = w((d, _DECAY_LORA))
        self.wa2 = w((_DECAY_LORA, d), fan_in=_DECAY_LORA)
        self.u = full((H, hd), 0.0)                          # bonus
        self.ln_x = full((d,), 1.0)
        self.ln2 = full((d,), 1.0)
        self.mu_cm = full((d,), 0.5)
        self.wk_cm = w((d, ff))
        self.wv_cm = w((ff, d), fan_in=ff)


def init_rwkv6(cfg, gen: torch.Generator, dtype=torch.float32) -> RWKV6:
    return RWKV6(cfg, gen, dtype)


def rwkv6_state(cfg, batch: int, dtype=torch.float32, device="cpu",
                tp=None):
    """The zero state of one layer; the WKV state holds the rank's H / tp
    heads at tp > 1, the token shifts the full width."""
    d = cfg.d_model
    H, hd = rwkv_dims(cfg)
    return {
        "wkv": torch.zeros((batch, H // tp_size(tp), hd, hd),
                           dtype=torch.float32,
                           device=device),              # (k-dim, v-dim)
        "x_tm": torch.zeros((batch, d), dtype=dtype, device=device),
        "x_cm": torch.zeros((batch, d), dtype=dtype, device=device),
    }


def _token_shift(x, prev):
    """x: (B,S,d); prev: (B,d) last token of the previous chunk."""
    return torch.cat([prev[:, None, :], x[:, :-1, :]], dim=1)


def _rwkv_mix(p: RWKV6, x, xx, lora=None):
    def mix(mu):
        return x + (xx - x) * mu

    def proj(mu, w, target):
        xm = mix(mu)
        return xm @ w + (lora(target, xm) if lora else 0.0)

    r = proj(p.mu_r, p.w_r, "q")        # the q adapter goes on the receptance
    k = proj(p.mu_k, p.w_k, "k")
    v = proj(p.mu_v, p.w_v, "v")
    g = mix(p.mu_g) @ p.w_g
    xw = mix(p.mu_w)
    w = torch.exp(-torch.exp(p.w0.float() +
                             (torch.tanh(xw @ p.wa1) @ p.wa2).float()))
    return r, k, v, g, w


def _rwkv_wkv(cfg, r, k, v, w, u, s0):
    """WKV recurrence in fp32. r/k/v/w: (B,S,H,hd); u: (H,hd) fp32; s0:
    (B,H,hd,hd) fp32. Returns (out (B,S,H,hd) fp32, state)."""
    r, k, v, w = (t.float() for t in (r, k, v, w))
    s = s0
    outs = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]       # (B,H,hdk,hdv)
        outs.append(torch.einsum("bhk,bhkv->bhv", r[:, t],
                                 s + u[..., None] * kv))
        s = w[:, t, :, :, None] * s + kv
    return torch.stack(outs, dim=1), s


def rwkv6_time_mix(cfg, p: RWKV6, x, state, lora=None, tp=None):
    """x: (B,S,d) (post-ln); state holds ``wkv`` (fp32) and ``x_tm`` (x's
    type). Returns (out, {"wkv", "x_tm"})."""
    B, S, _ = x.shape
    H, hd = p.u.shape                                    # this rank's heads
    xx = _token_shift(x, state["x_tm"])
    r, k, v, g, w = _rwkv_mix(p, x, xx, lora)
    out, s = _rwkv_wkv(cfg, *(t.reshape(B, S, H, hd) for t in (r, k, v, w)),
                       p.u.float(), state["wkv"])
    out = out.reshape(B, S, H * hd).to(x.dtype)
    out = rmsnorm_sharded(out, p.ln_x, cfg.rmsnorm_eps, tp) * F.silu(g)
    out = row_parallel_out(out @ p.w_o, lora("o", out) if lora else 0.0,
                           tp)
    return out, {"wkv": s, "x_tm": x[:, -1, :]}


def rwkv6_channel_mix(cfg, p: RWKV6, x, state, tp=None):
    xx = _token_shift(x, state["x_cm"])
    xm = x + (xx - x) * p.mu_cm
    h = torch.square(torch.relu(xm @ p.wk_cm))
    return all_reduce_(h @ p.wv_cm, tp), {"x_cm": x[:, -1, :]}
