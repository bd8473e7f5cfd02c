"""Config dataclasses for the model zoo and input shapes.

Every assigned architecture gets one file in this package constructing an
exact `ModelConfig` (citation in the file header) plus a `reduced()` smoke
variant (<=2 layers, d_model<=512, <=4 experts) used by CPU tests.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int                 # routed experts
    top_k: int
    d_ff_expert: int
    n_shared_experts: int = 0      # always-on shared experts (DeepSeek style)


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2)."""
    kv_lora_rank: int
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    q_lora_rank: int = 0           # 0 => full-rank q projection (V2-Lite)


@dataclass(frozen=True)
class SSMConfig:
    kind: str                      # "mamba2" | "rwkv6"
    d_state: int = 64
    head_dim: int = 64
    expand: int = 2                # inner = expand * d_model (mamba2)


@dataclass(frozen=True)
class EncoderConfig:
    """Encoder stack for enc-dec (audio) models. Frontend is a stub:
    inputs are precomputed frame embeddings (batch, n_frames, d_model)."""
    n_layers: int
    n_frames: int = 1024           # default source length for dry-run/train


@dataclass(frozen=True)
class LoRAConfig:
    """Serving-time LoRA attach points."""
    ranks: Tuple[int, ...] = (8, 16, 32, 64, 128)
    max_rank: int = 128
    targets: Tuple[str, ...] = ("q", "k", "v", "o")


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int                   # 0 for attention-free archs
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 => d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 1e4
    rmsnorm_eps: float = 1e-5
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    attn_every: int = 1            # hybrid: attention block period (0 = attn-free)
    shared_attn: bool = False      # Zamba2: one attention weight set reused
    cross_attn_every: int = 0      # vlm / enc-dec decoder: cross-attn period
    encoder: Optional[EncoderConfig] = None
    n_frontend_tokens: int = 0     # vlm: number of stub patch embeddings
    sliding_window: int = 0        # 0 = full attention; >0 = ring-buffer window
    lora: LoRAConfig = dataclasses.field(default_factory=LoRAConfig)
    source: str = ""               # citation for the exact numbers

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        if self.n_heads:
            return self.d_model // self.n_heads
        return 0

    @property
    def is_attention_free(self) -> bool:
        return self.ssm is not None and self.attn_every == 0

    def with_sliding_window(self, window: int) -> "ModelConfig":
        return dataclasses.replace(self, sliding_window=window)

    def n_params(self) -> int:
        """Approximate parameter count (embeddings + blocks), for roofline
        MODEL_FLOPS = 6*N*D."""
        d, ff, V = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim
        emb = V * d * (1 if self.tie_embeddings else 2)
        attn = 0
        if self.n_heads:
            q = d * self.n_heads * hd
            kv = 2 * d * self.n_kv_heads * hd
            o = self.n_heads * hd * d
            if self.mla is not None:
                m = self.mla
                qd = m.qk_nope_head_dim + m.qk_rope_head_dim
                q = d * self.n_heads * qd if not m.q_lora_rank else (
                    d * m.q_lora_rank + m.q_lora_rank * self.n_heads * qd)
                kv = d * (m.kv_lora_rank + m.qk_rope_head_dim) + \
                    m.kv_lora_rank * self.n_heads * (m.qk_nope_head_dim + m.v_head_dim)
                o = self.n_heads * m.v_head_dim * d
            attn = q + kv + o
        if self.moe is not None:
            e = self.moe
            ffp = (e.n_experts + e.n_shared_experts) * 3 * d * e.d_ff_expert \
                + d * e.n_experts
        else:
            ffp = 3 * d * ff
        ssmp = 0
        if self.ssm is not None:
            if self.ssm.kind == "mamba2":
                inner = self.ssm.expand * d
                ssmp = d * (2 * inner) + inner * d + inner * (2 * self.ssm.d_state) \
                    + inner  # in/out proj + B,C proj + dt
            else:  # rwkv6
                ssmp = 5 * d * d + d * ff * 2  # r,k,v,g,o + channel mix
        n_attn = self.n_attn_layers()
        n_ssm = self.n_ssm_layers()
        n_ff = self.n_layers if self.ssm is None else n_attn
        if self.shared_attn:
            blocks = attn + n_ssm * ssmp + n_ff * ffp
        elif self.ssm is not None and self.ssm.kind == "rwkv6":
            blocks = self.n_layers * ssmp
        else:
            blocks = n_attn * attn + n_ssm * ssmp + n_ff * ffp
        if self.cross_attn_every and self.n_heads:
            blocks += (self.n_layers // self.cross_attn_every) * attn
        if self.encoder is not None:
            blocks += self.encoder.n_layers * (attn + 3 * d * ff)
            blocks += self.n_layers * attn  # decoder cross-attn
        return emb + blocks

    def n_attn_layers(self) -> int:
        if self.is_attention_free:
            return 0
        if self.ssm is None:
            return self.n_layers
        # hybrid: one attn application every attn_every blocks
        return (self.n_layers + self.attn_every - 1) // self.attn_every

    def n_ssm_layers(self) -> int:
        if self.ssm is None:
            return 0
        if self.is_attention_free:
            return self.n_layers
        return self.n_layers  # hybrid: every block is SSM; attn is interleaved extra


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    mode: str                      # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}

# Window used by dense/moe/vlm/audio archs for the long_500k shape
# (sub-quadratic requirement): ring-buffer sliding-window attention.
LONG_CONTEXT_WINDOW = 4096
