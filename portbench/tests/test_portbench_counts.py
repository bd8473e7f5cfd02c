"""The yardstick's counts against hand counts."""
import pytest

from portbench import counts
from portbench.arch import deepseek_v2_ref, qwen2_ref
from portbench.harness import load_cell

QWEN = load_cell("qwen2.5-32b-l32.batch").config
DSV2 = load_cell("deepseek-v2-lite-16b.batch").config


def test_qwen_counts():
    # per layer: q and o 5120^2, k and v 5120 x 1024, SwiGLU 3 x 5120 x 27648
    layer = 2 * 5120 * 5120 + 2 * 5120 * 1024 + 3 * 5120 * 27648
    assert layer == 487_587_840
    assert qwen2_ref.matmul_params(QWEN) == 32 * layer + 5120 * 152064
    assert qwen2_ref.attn_flops(QWEN, 100) == 32 * 4 * 40 * 128 * 100
    assert qwen2_ref.lora_dims(QWEN) == {"q": (5120, 5120),
                                         "k": (5120, 1024),
                                         "v": (5120, 1024),
                                         "o": (5120, 5120)}
    # the served weights: 17.16 B parameters with the embedding
    total = 0
    for _, shape, _ in qwen2_ref.weight_specs(QWEN):
        k = 1
        for s in shape:
            k *= s
        total += k
    assert 17.1e9 < total < 17.2e9


def test_deepseek_counts_are_the_active_parameters():
    attn = 2048 * 16 * 192 + 2048 * 576 + 512 * 16 * 256 + 2048 * 2048
    ffn = 2048 * 64 + (6 + 2) * 3 * 2048 * 1408
    assert deepseek_v2_ref.matmul_params(DSV2) == \
        27 * (attn + ffn) + 2048 * 102400 == 2_453_405_696     # "A2.4B"
    assert deepseek_v2_ref.attn_flops(DSV2, 10) == 27 * 2 * 16 * 320 * 10
    assert set(deepseek_v2_ref.lora_dims(DSV2)) == {"q", "k", "o"}


def test_prefill_and_token_flops():
    ref, c = qwen2_ref, QWEN
    lora8 = 32 * 2 * 8 * (10240 + 6144 + 6144 + 10240)
    assert counts.token_flops(ref, c, 5, 8) == \
        2 * ref.matmul_params(c) + ref.attn_flops(c, 5) + lora8
    # a 3-token prompt: its tokens attend to 1, 2 and 3 keys
    assert counts.prefill_flops(ref, c, 3, 8) == sum(
        counts.token_flops(ref, c, k, 8) for k in (1, 2, 3))


def test_lora_call_bound_by_hand():
    pk = counts.peaks("NVIDIA H100 80GB HBM3")
    byts = 2 * (4 * 10240 + (8 + 128) * 10240)
    flops = 2 * 8 * 10240 * 3 + 2 * 128 * 10240
    got = counts.lora_call_bound_s(5120, 5120, {"a": 3, "b": 1},
                                   {"a": 8, "b": 128}, pk)
    assert got == pytest.approx(max(byts / 3.35e12, flops / 989e12))
    assert counts.peaks("cpu") is None
    with pytest.raises(ValueError):
        counts.peaks("some other card")

