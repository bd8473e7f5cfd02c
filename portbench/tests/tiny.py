"""Tiny cells for the CPU tests: the benchmark's own configurations,
traffic and engine settings with every size cut down (the widths too,
which a cell never does) and float32 weights, so a run takes seconds on
the CPU and the program's gaps are rounding alone."""
from __future__ import annotations

import copy
import json
from pathlib import Path

from portbench import harness

HERE = Path(__file__).resolve().parents[1]

SIZES = {
    "qwen2": {"hidden_size": 64, "intermediate_size": 96,
              "num_attention_heads": 4, "num_key_value_heads": 2,
              "num_hidden_layers": 2, "vocab_size": 256},
    "deepseek_v2": {"hidden_size": 64, "num_attention_heads": 4,
                    "num_key_value_heads": 4, "kv_lora_rank": 16,
                    "qk_nope_head_dim": 8, "qk_rope_head_dim": 8,
                    "v_head_dim": 8, "n_routed_experts": 4,
                    "num_experts_per_tok": 2, "n_shared_experts": 1,
                    "moe_intermediate_size": 32, "num_hidden_layers": 2,
                    "vocab_size": 256},
}


def tiny_cell(workload: str) -> harness.Cell:
    """The cell ``workload`` of BENCHMARK.json at the tiny sizes."""
    cell = copy.deepcopy(harness.load_cell(workload))
    # float32 weights: a tiny model's bf16 rounding tips near-ties that its
    # few layers do not damp, which the tiny limits are not set for
    cell.config.update(SIZES[cell.config["model_type"]],
                       torch_dtype="float32")
    mix = cell.mix
    mix["adapters"]["count"] = 5
    mix.update(prompt={"median": 8, "sigma": 0.4, "min": 4, "max": 16},
               output={"median": 8, "sigma": 0.4, "min": 4, "max": 16},
               jobs=64)
    cell.engine.update(max_batch=4, max_len=40)
    stat = cell.engine["check"]["statistic"]
    cell.engine["check"] = {"statistic": stat, "sample_tokens": 64,
                            "limit": {"widest_gap": 1e-3,
                                      "mean_gap": 1e-4}[stat]}
    return cell


def workloads():
    return [w["name"] for w in json.loads(
        (HERE.parent / "BENCHMARK.json").read_text())["workloads"]]
