"""The yardstick's arithmetic: published peaks, the model FLOPs a window's
tokens need, and the least time the LoRA work of one engine iteration
could take. Everything is counted from the inputs (tokens, contexts,
adapters, widths), never from what the program happens to launch.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates without sparsity (the numbers of
# repro_torch/launch/mesh.py:PARTS, copied)
PEAKS = {"NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12,
                                   "hbm_bytes_per_s": 3.35e12}}
ELEM = 2          # bytes of a served (bf16) value


def peaks(kind: str):
    """The card's peaks; None on the CPU (a CPU run reports no share of a
    device's peak)."""
    if kind == "cpu":
        return None
    if kind not in PEAKS:
        raise ValueError(f"no published peaks for {kind!r}")
    return PEAKS[kind]


def token_flops(ref, c: dict, ctx: int, rank: int) -> int:
    """FLOPs one token needs when it attends to ``ctx`` keys under an
    adapter of ``rank``: 2 per matrix parameter it meets, its attention,
    and its adapter's 2 r (d_in + d_out) a target a layer."""
    lora = sum(2 * rank * (a + b) for a, b in ref.lora_dims(c).values())
    return 2 * ref.matmul_params(c) + ref.attn_flops(c, ctx) + \
        c["num_hidden_layers"] * lora


def prefill_flops(ref, c: dict, prompt_len: int, rank: int) -> int:
    """A prompt's prefill: token i attends to i + 1 keys."""
    n = prompt_len
    lora = sum(2 * rank * (a + b) for a, b in ref.lora_dims(c).values())
    return n * (2 * ref.matmul_params(c) + c["num_hidden_layers"] * lora) \
        + ref.attn_flops(c, n * (n + 1) // 2)


def lora_call_bound_s(din: int, dout: int, tokens_by_adapter: dict,
                      ranks: dict, pk: dict) -> float:
    """The least time of one LoRA call (one target of one layer over one
    iteration's rows): x read and y written once, each adapter's A and B
    read once, 2 r (d_in + d_out) FLOPs a token, at the card's peaks."""
    t = sum(tokens_by_adapter.values())
    byts = ELEM * (t * (din + dout) + sum(
        ranks[a] * (din + dout) for a in tokens_by_adapter))
    flops = sum(2 * ranks[a] * (din + dout) * n
                for a, n in tokens_by_adapter.items())
    return max(byts / pk["hbm_bytes_per_s"], flops / pk["bf16_flops"])
