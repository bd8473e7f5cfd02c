"""The check's calibration: for each seed, one run of the cell (a short
window at the cell's own load), then the widest gap of what the program
served and the widest gap of the control (the reference on float8
weights) over the same sample. The limit in ``cells/<workload>.json``
lies between the largest of the first and the smallest of the second.
The benchmark's own runs never run the control.

  python3 -m portbench.control --workload <name> --seconds <s> \\
      --seeds 11,12,13

One JSON line a seed; the seeds run one after another in this process.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys

from portbench import run  # noqa: F401  (puts src/ on the path)
from portbench import harness

import torch  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.control: needs a CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    for seed in [int(s) for s in args.seeds.split(",")]:
        out = harness.run_cell(cell, seed, args.seconds, False, "cuda",
                               control=True)
        print(json.dumps({"seed": seed, "compared": out["compared"],
                          "metrics": out["metrics"],
                          "attempted": out["attempted"],
                          "failed": out["failed"]}), flush=True)
        del out
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
