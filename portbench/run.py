"""Run one cell of the port's benchmark once and print its result.

  python3 -m portbench.run --workload <name> --seed <n> --seconds <s> \\
      --trace <0|1>

from the root of a checkout. The cell, its configuration, traffic and
metrics are found by name (``BENCHMARK.json``, ``portbench/``). The last
line of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (with ``--trace 0`` the cell's end-to-end
metrics, with ``--trace 1`` its per-layer ones), ``device`` (with
``--trace 1`` also ``busy_s`` and ``window_s``), with ``--trace 1`` the
``breakdown`` of the traced slice, and last ``compared``: each number the
check compared, beside its limit. The same numbers end standard error.

It exits with 2 and prints no result where no CUDA card is visible or
fewer than the cell asks for, and with 3 where a module of JAX or of the
JAX package was loaded in this process.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# the program's build and kernel caches: fixed directories in the checkout
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" /
                                                  "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from portbench import check, harness  # noqa: E402


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def chips_of(workload: str) -> int:
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (w,) = [w for w in bench["workloads"] if w["name"] == workload]
    return w["chips"]


def main(argv=None) -> int:
    args = parse_args(argv)
    chips = chips_of(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    # one host thread: the host drives the card, and a pool of spinning
    # threads would take its cores
    torch.set_num_threads(1)
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           "cuda")
    # after the window closed, in the process that prints the result
    leaked = harness.forbidden_modules()
    if leaked:
        print(f"portbench: loaded {leaked}, of JAX or the JAX package",
              file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": out["kind"], "count": chips,
              "memory_peak_bytes": out["memory_peak_bytes"]}
    stat = cell.engine["check"]["statistic"]
    result = {"correct": check.correct(out["compared"], stat),
              "attempted": out["attempted"], "failed": out["failed"],
              "metrics": out["metrics"], "device": device}
    if args.trace:
        device.update(busy_s=out["busy_s"], window_s=out["window_s"])
        result["breakdown"] = out["breakdown"]
    result["compared"] = out["compared"]
    for name, v in out["compared"].items():
        print(f"compared {name} {v['value']} limit {v['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
