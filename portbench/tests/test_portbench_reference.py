"""The plain reference against the port on the reduced configurations:
float32 weights and adapters from the benchmark, the port's prefill and
greedy decode through its cache (bucketed bank, the SGMV path's plain
versions on the CPU), every step's logits against the reference's full
forward pass."""
import importlib

import pytest
import torch

from portbench import weights
from portbench.tests.tiny import SIZES, tiny_cell

from repro_torch.lora.bank import build_bank
from repro_torch.models import model as M

CELLS = {"qwen2": "qwen2.5-32b-l32.batch",
         "deepseek_v2": "deepseek-v2-lite-16b.batch"}


@pytest.mark.parametrize("arch", sorted(SIZES))
def test_port_prefill_and_decode_match_the_reference(arch):
    c = tiny_cell(CELLS[arch]).config
    ref = importlib.import_module(f"portbench.arch.{arch}_ref")
    port = importlib.import_module(f"portbench.arch.{arch}")
    L = c["num_hidden_layers"]
    w = weights.base_weights(ref.weight_specs(c), 3, "cpu", torch.float32)
    ads = [("a-r8", 8, 0.5), ("b-r32", 32, 0.5)]
    aw = weights.adapter_weights(ads, ref.lora_dims(c), L, 3, "cpu",
                                 torch.float32)
    cfg = port.port_config("tiny", c)
    params = port.port_params(cfg, w)
    bank = build_bank(cfg, {a: r for a, r, _ in ads}, 0, mode="bucketed",
                      n_layers=L, dtype=torch.float32, device="cpu")
    for a, r, _ in ads:
        bank.set_adapter(a, aw[a])
    idx = bank.lora_idx(torch.tensor([bank.index(a) for a, _, _ in ads],
                                     dtype=torch.int32))
    toks = torch.randint(1, c["vocab_size"], (2, 7),
                         generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        lg, cache = M.prefill(cfg, params, toks, bank=bank.data,
                              lora_idx=idx, cache_len=16,
                              cache_dtype=torch.float32, lora_kernel="sgmv")
        steps, seq = [lg], toks
        for _ in range(4):
            nxt = steps[-1].argmax(-1)
            seq = torch.cat([seq, nxt[:, None]], 1)
            lg, cache = M.decode_step(cfg, params, cache, nxt,
                                      bank=bank.data, lora_idx=idx,
                                      lora_kernel="sgmv")
            steps.append(lg)
        got = torch.stack(steps, 1)                     # (2, 5, V)
        for row, (a, _, _) in enumerate(ads):
            want = ref.forward(c, w, seq[row], aw[a], torch.arange(6, 11))
            scale = want.abs().max()
            assert (got[row] - want).abs().max() <= 1e-4 * scale
