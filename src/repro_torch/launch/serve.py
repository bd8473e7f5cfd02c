"""Serving launcher of the PyTorch port: one single-server engine over
``llama-7b-paper`` with adapters of ranks {8, 16, 32, 64, 128}, serving a
batch of requests and printing TTFT / TBT and decode tokens/s.

Example (on the card, full width, bf16 weights from a seed):
  PYTHONPATH=src python -m repro_torch.launch.serve --config full \\
      --bank-mode bucketed --decode-block 4 --requests 16

``--config smoke`` serves the reduced config; ``--device cpu`` runs on the
CPU with the kernels' plain versions. Base and adapter weights are random
from ``--seed``, the adapters' B nonzero (a fresh bank's B is zero, which
would make every delta 0). ``--profile`` traces the served run with
``torch.profiler`` and prints device time by kernel, the device's busy
share of the run, and the idle gaps between kernels by size.

``--mesh 1,TP`` serves on a tensor-parallel engine of TP ranks, one
process each, spawned here (``launch.mesh.spawn``) and meeting over
``--backend`` (nccl: one card per rank; gloo: also on the CPU, or several
ranks on one card). Every rank serves the same trace; rank 0 prints the
report. Example, on the CPU:
  PYTHONPATH=src python -m repro_torch.launch.serve --config smoke \
      --device cpu --mesh 1,2 --backend gloo
"""
from __future__ import annotations

import argparse
import random
import tempfile
import time
from pathlib import Path

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch.mesh import make_engine_mesh, spawn
from repro_torch.models import model as M
from repro_torch.serving import Request, ServingEngine

RANKS = (8, 16, 32, 64, 128)


def build_trace(cfg, n_requests: int, prompt_lens, max_new: int, seed: int):
    """Requests over adapters ``ad{i}-r{rank}`` round-robin, prompts of the
    given lengths in turn, tokens from ``seed``."""
    rng = random.Random(seed)
    trace = []
    for i in range(n_requests):
        rank = RANKS[i % len(RANKS)]
        prompt = [rng.randrange(1, cfg.vocab_size)
                  for _ in range(prompt_lens[i % len(prompt_lens)])]
        trace.append((f"ad{i % len(RANKS)}-r{rank}", prompt, max_new))
    return trace


def serve(cfg, params, trace, *, bank_mode="padded", lora_kernel="sgmv",
          decode_block=1, max_batch=8, seed=0, weights=None, mesh=None,
          device="cuda"):
    """Serve ``trace`` [(adapter, prompt, max_new)] on one engine until it
    drains. ``weights`` ({adapter: {target: {"A", "B"}}}, optional, full
    width) are installed over the bank's own (whose B is zero) before
    serving. ``mesh``: this rank's ``TensorParallel`` (every rank calls
    ``serve`` with the same arguments). Returns (engine, requests,
    summary dict)."""
    adapters = {aid: int(aid.rsplit("-r", 1)[1]) for aid, _, _ in trace}
    max_len = max(len(p) + n for _, p, n in trace) + 8
    eng = ServingEngine(cfg, params, adapters, max_batch=max_batch,
                        max_len=max_len, seed=seed, bank_mode=bank_mode,
                        decode_block=decode_block, lora_kernel=lora_kernel,
                        mesh=mesh, device=device)
    for aid, w in (weights or {}).items():
        eng.install_adapter(aid, adapters[aid], w)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.monotonic()
    reqs = [Request(i, aid, prompt, n, arrival=t0)
            for i, (aid, prompt, n) in enumerate(trace)]
    for r in reqs:
        eng.submit(r)
    summ = eng.run_until_drained()
    wall = time.monotonic() - t0
    decode_s = max(r.t_finish for r in reqs) - min(r.t_first_token
                                                   for r in reqs)
    summ.update(wall_s=wall, decode_tokens=eng.tokens_decoded,
                decode_tok_s=eng.tokens_decoded / decode_s if decode_s > 0
                else float("nan"))
    return eng, reqs, summ


def adapter_weights(cfg, ranks, *, dtype, device, seed):
    """Nonzero A ~ N(0, 1/d) and B ~ N(0, 0.25/r) per adapter id, from
    one ``torch.Generator``."""
    g = torch.Generator(device=device).manual_seed(seed)
    L, d = cfg.n_layers, cfg.d_model
    return {aid: {t: {"A": (torch.randn((L, d, r), generator=g,
                                        device=device) / d ** 0.5).to(dtype),
                      "B": (torch.randn((L, r, d), generator=g,
                                        device=device)
                            * (0.5 / r ** 0.5)).to(dtype)}
                  for t in cfg.lora.targets}
            for aid, r in ranks.items()}


def profiled(fn, device):
    """Run ``fn()`` under ``torch.profiler``; print the kernels by device
    time and the device's busy share of the wall time. Returns fn()."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        t0 = time.monotonic()
        out = fn()
        wall = time.monotonic() - t0
    if len(acts) == 1:
        print(f"profile: wall {wall:.3f}s on the CPU: no device time")
        return out
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    print(f"profile: wall {wall:.3f}s, device busy {busy:.3f}s "
          f"({busy / wall:.1%}), idle {1 - busy / wall:.1%}, "
          f"{sum(e.count for e in kernels)} kernel launches")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"profile: {e.self_device_time_total / 1e3:10.2f} ms "
              f"{e.count:7d} x  {e.key[:90]}")
    _print_gaps(prof)
    return out


def _print_gaps(prof, top=5):
    """The device's idle time between consecutive kernels (time the host
    kept it waiting: launch overhead, host work, syncs), by size, and the
    largest gaps with the kernels around them."""
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    gaps = sorted(((b[0] - a[1], a[2], b[2]) for a, b in
                   zip(spans, spans[1:]) if b[0] > a[1]), reverse=True)
    for lo, hi in ((0, 10), (10, 100), (100, 1000), (1000, float("inf"))):
        sel = [g for g, _, _ in gaps if lo <= g < hi]
        print(f"profile: gaps {lo}-{hi} us: {len(sel)}, "
              f"{sum(sel) / 1e3:.2f} ms")
    for g, before, after in gaps[:top]:
        print(f"profile: gap {g / 1e3:8.3f} ms after {before[:45]!r} "
              f"before {after[:45]!r}")


def _serve_rank(rank: int, dp: int, tp: int, args) -> None:
    """Build the model and serve the trace as rank ``rank`` of a (dp, tp)
    engine; rank 0 prints the report."""
    mesh = make_engine_mesh(dp, tp, device=args.device)
    device = torch.device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    cfg = (get_config if args.config == "full" else get_smoke_config)(
        "llama-7b-paper")
    dtype = getattr(torch, args.dtype)
    params = M.init_params(cfg, args.seed, dtype=dtype, device=device)
    trace = build_trace(cfg, args.requests,
                        [int(v) for v in args.prompt_lens.split(",")],
                        args.max_new, args.seed)
    weights = adapter_weights(
        cfg, {aid: int(aid.rsplit("-r", 1)[1]) for aid, _, _ in trace},
        dtype=dtype, device=device, seed=args.seed)

    def run():
        return serve(cfg, params, trace, bank_mode=args.bank_mode,
                     lora_kernel=args.lora_kernel,
                     decode_block=args.decode_block,
                     max_batch=args.max_batch, seed=args.seed,
                     weights=weights, mesh=mesh, device=device)

    profile = args.profile and rank == 0
    eng, reqs, s = profiled(run, device) if profile else run()
    if rank != 0:
        return
    where = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    print(f"model={cfg.name} layers={cfg.n_layers} dtype={args.dtype} "
          f"device={where} mesh={dp},{tp} bank_mode={args.bank_mode} "
          f"lora_kernel={args.lora_kernel} decode_block={args.decode_block}")
    print(f"finished={s['finished']}/{len(reqs)} "
          f"p50_ttft={s['p50_ttft'] * 1e3:.1f}ms "
          f"p95_ttft={s['p95_ttft'] * 1e3:.1f}ms "
          f"mean_tbt={s['mean_tbt'] * 1e3:.2f}ms "
          f"decode_tok/s={s['decode_tok_s']:.1f} "
          f"prefill_calls={eng.prefill_dispatches} "
          f"decode_calls={eng.decode_dispatches}", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="full", choices=["full", "smoke"])
    ap.add_argument("--bank-mode", default="padded",
                    choices=["padded", "bucketed"])
    ap.add_argument("--lora-kernel", default="sgmv",
                    choices=["sgmv", "einsum"],
                    help="LoRA delta: the hand-written SGMV kernels (their "
                         "plain versions on the CPU) or gather-einsum")
    ap.add_argument("--decode-block", type=int, default=1,
                    help="decode tokens per host sync "
                         "(ServingEngine.decode_steps(k))")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-lens", default="64,128",
                    help="comma-separated prompt lengths, used in turn")
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["bfloat16", "float32"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="trace the run with torch.profiler; print device "
                         "time by kernel and the device's busy share")
    ap.add_argument("--mesh", default="1,1",
                    help="DP,TP: TP tensor-parallel ranks (DP must be 1)")
    ap.add_argument("--backend", choices=["nccl", "gloo"],
                    help="torch.distributed backend of the ranks (default: "
                         "nccl on cuda, gloo on cpu)")
    args = ap.parse_args()
    dp, tp = (int(v) for v in args.mesh.split(","))
    if tp == 1 or dp != 1:              # dp > 1 is refused before a spawn
        _serve_rank(0, dp, tp, args)
        return
    backend = args.backend or ("nccl" if args.device == "cuda" else "gloo")
    with tempfile.TemporaryDirectory() as tmp:
        spawn(_serve_rank, tp, backend=backend,
              init_file=Path(tmp) / "init", args=(dp, tp, args))


if __name__ == "__main__":
    main()
