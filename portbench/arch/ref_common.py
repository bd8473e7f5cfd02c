"""Plain float32 pieces shared by the architectures' references.

Everything here is straightforward PyTorch on float32 tensors: no kernel,
no cache, no batching, and nothing of the program under test. Weights are
upcast from the type they are served in as each layer is reached, so a
reference pass holds one layer in float32 at a time beside the served
weights.

``quantize`` is the control's precision: the reference computed on
weights rounded to float8 (e4m3, one scale per output column), the step
below the bfloat16 the configurations state.
"""
from __future__ import annotations

import torch

# float32 products stay float32: no TF32 in a reference
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

_FP8_MAX = 448.0


def quantize(w: torch.Tensor, axis: int = -2) -> torch.Tensor:
    """``w`` rounded to float8 e4m3 with one absmax scale per slice along
    ``axis`` (the reduced axis of ``x @ w``: per output column), returned
    in float32."""
    w = w.float()
    scale = w.abs().amax(dim=axis, keepdim=True).clamp_min(1e-12) / _FP8_MAX
    return (w / scale).to(torch.float8_e4m3fn).float() * scale


class Weights:
    """A view of the served weights as the reference reads them: every
    leaf upcast to float32, or rounded to float8 first under the
    control."""

    def __init__(self, tensors: dict, control: bool = False):
        self.tensors = tensors
        self.control = control

    def __call__(self, name: str, *index, matrix: bool = True):
        t = self.tensors[name]
        for i in index:
            t = t[i]
        if self.control and matrix:
            return quantize(t)
        return t.float()


def rmsnorm(x, scale, eps: float):
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * scale


def rope(x, positions, theta: float):
    """x: (S, H, hd), positions (S,): the two halves of each head rotated
    by the angles of ``positions``."""
    hd = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                       device=x.device) / hd)
    ang = positions.float()[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def causal_attention(q, k, v, scale: float, chunk: int = 1024):
    """q: (S, H, dq), k: (S, H, dq), v: (S, H, dv), every head its own
    keys; causal softmax attention in float32, queries in chunks."""
    S = q.shape[0]
    out = []
    kt = k.permute(1, 2, 0)                                  # (H, dq, S)
    vh = v.transpose(0, 1)                                   # (H, S, dv)
    for lo in range(0, S, chunk):
        hi = min(S, lo + chunk)
        s = torch.matmul(q[lo:hi].transpose(0, 1), kt[:, :, :hi]) * scale
        mask = torch.arange(hi, device=q.device)[None, :] > \
            torch.arange(lo, hi, device=q.device)[:, None]
        s = s.masked_fill(mask, float("-inf"))
        out.append(torch.matmul(torch.softmax(s, dim=-1), vh[:, :hi])
                   .transpose(0, 1))
    return torch.cat(out, dim=0)


def swiglu(x, w1, w3, w2):
    return (torch.nn.functional.silu(x @ w1) * (x @ w3)) @ w2


def lora(x, adapter, target: str, layer: int, control: bool):
    """The adapter's delta on ``target`` at ``layer``: (x @ A) @ B, or 0
    where the adapter has no such target."""
    if adapter is None or target not in adapter:
        return 0.0
    a = adapter[target]["A"][layer]
    b = adapter[target]["B"][layer]
    if control:
        a, b = quantize(a), quantize(b)
    return (x @ a.float()) @ b.float()


def logits_at(h, w: Weights, positions, chunk: int = 512):
    """float32 logits (len(positions), V) of the final hidden states h at
    ``positions``."""
    head = w("lm_head")
    return torch.cat([h[positions[i:i + chunk]] @ head
                      for i in range(0, len(positions), chunk)])
