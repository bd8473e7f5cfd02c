"""Render the dry-run's tables (``launch/dryrun.py``'s artifact
directory): the roofline terms and the per-case argument, temp and
collective bytes. A copy of the JAX package's ``launch/report.py``.

  PYTHONPATH=src python -m repro_torch.launch.report \
      [--dir experiments/dryrun_torch] [--table roofline|dryrun]
"""
from __future__ import annotations

import argparse
import glob
import json
import os


def load(dir_):
    out = {}
    for p in sorted(glob.glob(os.path.join(dir_, "*.json"))):
        d = json.load(open(p))
        out[(d["arch"], d["shape"], d["mesh"])] = d
    return out


def fmt_s(x):
    return f"{x:.3e}"


def roofline_table(arts, mesh="16x16"):
    lines = [
        "| arch | shape | t_compute (s) | t_memory (s) | t_collective (s) "
        "| bottleneck | MODEL/HLO FLOPs |",
        "|---|---|---|---|---|---|---|",
    ]
    for (arch, shape, m), d in sorted(arts.items()):
        if m != mesh:
            continue
        lines.append(
            f"| {arch} | {shape} | {fmt_s(d['t_compute'])} | "
            f"{fmt_s(d['t_memory'])} | {fmt_s(d['t_collective'])} | "
            f"**{d['bottleneck']}** | {d['useful_flops_frac']:.2f} |")
    return "\n".join(lines)


def dryrun_table(arts):
    lines = [
        "| arch | shape | mesh | compile (s) | HLO GFLOPs | arg GB/dev | "
        "temp GB/dev | coll GB/dev |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for (arch, shape, m), d in sorted(arts.items()):
        mem = d["memory"]
        lines.append(
            f"| {arch} | {shape} | {m} | {d['compile_s']} | "
            f"{d['hlo_flops'] / 1e9:.0f} | "
            f"{(mem['argument_bytes'] or 0) / 1e9:.2f} | "
            f"{(mem['temp_bytes'] or 0) / 1e9:.2f} | "
            f"{d['collective_bytes'] / 1e9:.2f} |")
    return "\n".join(lines)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun")
    ap.add_argument("--table", default="roofline",
                    choices=["roofline", "dryrun"])
    args = ap.parse_args()
    arts = load(args.dir)
    if args.table == "roofline":
        print(roofline_table(arts))
    else:
        print(dryrun_table(arts))


if __name__ == "__main__":
    main()
