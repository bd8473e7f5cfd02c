"""Time the SGMV kernels of several source trees of the port in one call.

    python -m repro_torch.launch.kernel_ab ROOT [ROOT ...]

Each ROOT holds a ``src/repro_torch`` (for instance the parent commit,
unpacked with ``git archive HEAD src/repro_torch | tar -x -C ROOT`` into
a directory that ``.gitignore`` lists, beside the working tree). Each
tree runs in a process of its own, which builds its kernels into
``ROOT/build/repro_torch``, in the order given: name the trees as parent,
change, change, parent to see the spread. Every tree gets the same seeded
bf16 inputs at llama-7b-paper's widths (d = d_out = 4096, bucket ranks
8..128):

* B2 at decode (8 rows, each its own adapter: 8 blocks of one live row)
  and on the 2 x 1000-token prefill group (two rows at ranks 64 and 32)
  at block_t 16, and 64 where the tree takes it; at decode also every
  block spare (the launch's floor);
* B4a at decode and prefill at tp = 2 (d 2048), and at decode at d 4096,
  with B4b on its output;
* B1 and B3a on a padded bank (rank 128) at decode and prefill.

A tree whose wrappers take ``block_live`` gets the blocks' live-row
counts. Times: median of 30 launches over CUDA events, 128 MB written
between launches to flush L2, the card spinning before each start event
(``chip_smoke.py``'s timing). Prints each tree's times, nvidia-smi's
card name and power limit, and a table with a column per tree. Needs a
CUDA card.
"""
from __future__ import annotations

import json
import subprocess
import sys

_CHILD = r'''
import inspect, json, statistics, sys
sys.path.insert(0, sys.argv[1] + "/src")
import torch
from repro_torch.kernels import build, ops, sgmv
build.build()
dev = torch.device("cuda")
dt = torch.bfloat16
g = torch.Generator(device="cpu").manual_seed(0)
flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)


def ms(call, reps=30):
    for _ in range(3):
        call()
    ts = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(5_000_000)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        call()
        e.record()
        e.synchronize()
        ts.append(s.elapsed_time(e))
    return statistics.median(ts)


def rnd(*shape):
    return (torch.randn(*shape, generator=g) * 0.05).to(dev, dt)


def live_kw(fn, dest, T_pad, bt):
    if "block_live" not in inspect.signature(fn).parameters:
        return {}
    blk = dest.long() // bt
    live = torch.zeros(T_pad // bt, dtype=torch.int32, device=dev)
    return {"block_live": live.scatter_add_(
        0, blk, torch.ones_like(blk, dtype=torch.int32))}


banks = [(rnd(8, 4096, r), rnd(8, r, 4096)) for r in (8, 16, 32, 64, 128)]
out = {}
for name, T, buckets, sizes in (("decode", 8, [0, 1, 2, 3, 4, 0, 1, 2],
                                 (16,)),
                                ("prefill", 2000, [3, 2], (16, 64))):
    rows = len(buckets)
    bucket = torch.tensor(buckets, dtype=torch.int32, device=dev)
    local = torch.arange(rows, dtype=torch.int32, device=dev)
    tok = torch.arange(rows, dtype=torch.int32,
                       device=dev).repeat_interleave(T // rows)
    x = (torch.randn(T, 4096, generator=g)).to(dev, dt)
    for bt in sizes:
        dest, bb, br, xp = ops.bucketed_layout(x, tok, bucket, local, 5, bt)
        kw = dict(block_t=bt, **live_kw(sgmv.sgmv_multibank_blocks, dest,
                                        xp.shape[0], bt))
        try:
            sgmv.sgmv_multibank_blocks(xp, banks, bb, br, **kw)
        except ValueError:                       # block_t the tree refuses
            continue
        out[f"B2 {name} block_t={bt}"] = ms(
            lambda: sgmv.sgmv_multibank_blocks(xp, banks, bb, br, **kw))
        if name == "decode" and "block_live" in kw:
            spare = dict(kw, block_live=torch.zeros_like(kw["block_live"]))
            out["B2 decode all spare"] = ms(
                lambda: sgmv.sgmv_multibank_blocks(xp, banks, bb, br,
                                                   **spare))
    dest, bb, br, xp = ops.bucketed_layout(x, tok, bucket, local, 5, 16)
    kw = live_kw(sgmv.sgmv_multibank_shrink, dest, xp.shape[0], 16)
    As = [A[:, :2048].contiguous() for A, _ in banks]
    xh = xp[:, :2048].contiguous()
    out[f"B4a tp2 {name}"] = ms(
        lambda: sgmv.sgmv_multibank_shrink(xh, As, bb, br, **kw))
    if name == "decode":
        A_full = [A for A, _ in banks]
        out["B4a decode d4096"] = ms(
            lambda: sgmv.sgmv_multibank_shrink(xp, A_full, bb, br, **kw))
        h = sgmv.sgmv_multibank_shrink(xp, A_full, bb, br, **kw)
        B_full = [B for _, B in banks]
        out["B4b decode d4096"] = ms(
            lambda: sgmv.sgmv_multibank_expand(h, B_full, bb, br))
    Na = 5 if name == "decode" else 2
    aid = (torch.arange(T, device=dev) % Na).to(torch.int32) \
        if name == "decode" else tok
    Ap, Bp = rnd(Na, 4096, 128), rnd(Na, 128, 4096)
    dest, ba, xp = ops.segment_layout(x, aid, Na, 16)
    kw = live_kw(sgmv.sgmv_fused_blocks, dest, xp.shape[0], 16)
    out[f"B1 {name}"] = ms(
        lambda: sgmv.sgmv_fused_blocks(xp, Ap, Bp, ba, **kw))
    out[f"B3a {name}"] = ms(lambda: sgmv.sgmv_shrink(xp, Ap, ba, **kw))
print("RESULT " + json.dumps(out), flush=True)
'''


def main(roots) -> int:
    rows = []
    for root in roots:
        proc = subprocess.run([sys.executable, "-c", _CHILD, root],
                              capture_output=True, text=True)
        line = [ln for ln in proc.stdout.splitlines()
                if ln.startswith("RESULT ")]
        if proc.returncode or not line:
            print(f"{root}: failed ({proc.returncode})\n{proc.stderr[-4000:]}")
            return 1
        rows.append(json.loads(line[0][len("RESULT "):]))
        print(root, rows[-1], flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    print(f"{'ms':28s} " + "  ".join(roots))
    for key in sorted(set().union(*rows)):
        print(f"{key:28s} " + "  ".join(
            f"{r[key]:.4f}" if key in r else "   -  " for r in rows))
    return 0


if __name__ == "__main__":
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    sys.exit(main(sys.argv[1:]))
