#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and check it end to end.

    python3 chip_smoke.py          # from the repository root, one card

Phases (any failure raises; the script then exits non-zero):
  1. device  — the card's name and power limit; build the CUDA kernels
               from ``src/repro_torch/kernels/csrc`` with nvcc.
  2. engine  — the main path: ``repro_torch.launch.serve.serve`` on
               llama-7b-paper at full width (32 layers, bf16 weights from
               a seed, fp32 cache), padded and bucketed banks, decode
               blocks 1 and 4, 8 requests over 5 adapters with nonzero
               weights; every request gets its 16 tokens, the mode's
               kernel launches 4 x 32 times per prefill group and per
               decode step, all four runs emit the same tokens. The
               arguments of each kernel's largest (prefill) and smallest
               (decode) call are copied as the path runs.
  3. kernels — B1 ``sgmv_fused_blocks`` and B2 ``sgmv_multibank_blocks``
               against their plain-torch versions on those copied
               arguments, in bf16 and cast to fp32; times from CUDA
               events with L2 flushed between launches, and the bound
               from the bytes and operations the call needs.
  4. parity  — fp32, full width, 2 layers: kernel and einsum engines,
               padded and bucketed, emit the same tokens; prefill logits
               agree within 1e-3.
Then a ``kernels`` JSON line, the nvidia-smi line, and as the last line
``{"ok": true, "device": {...}}``. TF32 is off for matmuls and cuDNN, so
fp32 products run in full fp32 on both sides of every comparison.
"""
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

HBM_BYTES_PER_S = 3.35e12             # H100 SXM data sheet
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
BLOCK_T = 16


def log(*a):
    print(*a, flush=True)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 3: the kernels against their plain versions, at the main path's
# own calls
# ---------------------------------------------------------------------------


def _copy(a):
    if isinstance(a, torch.Tensor):
        return a.clone()
    if isinstance(a, (tuple, list)):
        return type(a)(_copy(v) for v in a)
    return a


def _cast(a, dtype):
    if isinstance(a, torch.Tensor):
        return a.to(dtype) if a.is_floating_point() else a
    if isinstance(a, (tuple, list)):
        return type(a)(_cast(v, dtype) for v in a)
    return a


class MainPathCalls:
    """Stands in, while it is entered, for the names under which
    ``kernels/ops.py`` calls the kernel wrappers and ``scatter_rows``. It
    forwards every call unchanged (the wrappers count their own launches)
    and keeps a copy of the arguments of each kernel's smallest x_pad (a
    decode step) and largest (a prefill group), with the ``dest`` that laid
    its tokens out."""

    NAMES = ("scatter_rows", "sgmv_fused_blocks", "sgmv_multibank_blocks")

    def __init__(self):
        from repro_torch.kernels import ops
        self.ops = ops
        self.orig = {n: getattr(ops, n) for n in self.NAMES}
        self.calls = {}          # (kernel, layout) -> (args, dest)
        self._dest = None

    def __enter__(self):
        def scatter_rows(x, dest, T_pad):
            self._dest = dest
            return self.orig["scatter_rows"](x, dest, T_pad)
        self.ops.scatter_rows = scatter_rows
        for name in self.NAMES[1:]:
            setattr(self.ops, name, self._recorder(name))
        return self

    def __exit__(self, *exc):
        for n, f in self.orig.items():
            setattr(self.ops, n, f)

    def _recorder(self, name):
        fn = self.orig[name]

        def call(*args, block_t):
            rows = args[0].shape[0]
            for layout, keep in (("decode", lambda a, b: a < b),
                                 ("prefill", lambda a, b: a > b)):
                kept = self.calls.get((name, layout))
                if kept is None or keep(rows, kept[0][0].shape[0]):
                    self.calls[(name, layout)] = (_copy(args),
                                                  self._dest.clone())
            return fn(*args, block_t=block_t)
        return call


def _work(name, args, dest, item):
    """(bytes, FLOPs) the call needs: the live rows of x read and of the
    output written, each used adapter's A and B once at the rank the call
    gives it, the block indices, and 2 * r * (d + d_out) FLOPs per live
    token at its own adapter's rank."""
    x_pad = args[0]
    d = x_pad.shape[1]
    T = dest.shape[0]
    live = (dest.long() // BLOCK_T).tolist()
    if name == "sgmv_fused_blocks":
        A, B, ba = args[1:]
        d_out, r = B.shape[-1], A.shape[-1]
        ba = ba.tolist()
        used = {ba[i]: r for i in set(live)}
        tok_r = [r] * T
        idx_bytes = 4 * len(ba)
    else:
        banks, bkt, row = args[1:]
        d_out = banks[0][1].shape[-1]
        rank = [A.shape[-1] for A, _ in banks]
        bkt, row = bkt.tolist(), row.tolist()
        used = {(bkt[i], row[i]): rank[bkt[i]] for i in set(live)}
        tok_r = [rank[bkt[i]] for i in live]
        idx_bytes = 8 * len(bkt)
    byts = (T * (d + d_out) + sum(used.values()) * (d + d_out)) * item \
        + idx_bytes
    flops = sum(2 * r * (d + d_out) for r in tok_r)
    return byts, flops


def _time_ms(fn, args, flush, reps=20):
    """Median ms of one call over CUDA events, L2 flushed before each."""
    for _ in range(3):
        fn(*args, block_t=BLOCK_T)
    times = []
    for _ in range(reps):
        flush.zero_()
        s, e = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        s.record()
        fn(*args, block_t=BLOCK_T)
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def phase_kernels(dev, calls):
    """Each kernel wrapper and its plain version on the arguments of the
    main path's own calls (bf16, as the engine ran them, and the same
    tensors cast to fp32), every row of every whole block compared."""
    from repro_torch.kernels import sgmv
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    results = {}
    for (name, layout), (args0, dest) in sorted(calls.items()):
        fn, plain = getattr(sgmv, name), getattr(sgmv, name + "_ref")
        for dtype in (torch.bfloat16, torch.float32):
            args = _cast(args0, dtype)
            y = fn(*args, block_t=BLOCK_T)
            ref = plain(*args, block_t=BLOCK_T)
            torch.cuda.synchronize()
            x_pad = args[0]
            nblocks = x_pad.shape[0] // BLOCK_T
            yk = y[:nblocks * BLOCK_T].float()
            yr = ref[:nblocks * BLOCK_T].float()
            assert torch.isfinite(yk).all(), f"{name}: non-finite output"
            err = (yk - yr).abs().max().item()
            tol = TOL[dtype]
            assert torch.allclose(yk, yr, atol=tol, rtol=tol), \
                f"{name} {layout} {dtype}: max abs err {err} > tol {tol}"
            ms = _time_ms(fn, args, flush)
            plain_ms = _time_ms(plain, args, flush)
            byts, flops = _work(name, args, dest, x_pad.element_size())
            t_bytes = byts / HBM_BYTES_PER_S * 1e3
            t_ops = flops / PEAK_FLOPS[dtype] * 1e3
            bound_ms, bound_by = max((t_bytes, "bytes"), (t_ops, "operations"))
            log(f"kernel {name} layout={layout} dtype={str(dtype)[6:]} "
                f"x_pad={tuple(x_pad.shape)} blocks={nblocks} "
                f"live_rows={dest.shape[0]} max_abs_err={err:.3e} tol={tol} "
                f"ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bound_ms:.5f}"
                f" ({bound_by}: {byts} B, {flops} FLOP)")
            results[(name, layout, dtype)] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by)
    del flush
    return results


# ---------------------------------------------------------------------------
# phases 3 and 4: the engine
# ---------------------------------------------------------------------------


def phase_engine(dev):
    from repro_torch.configs import get_config
    from repro_torch.kernels import sgmv
    from repro_torch.launch.serve import adapter_weights, build_trace, serve
    from repro_torch.models import model as M
    cfg = get_config("llama-7b-paper")
    t0 = time.monotonic()
    params = M.init_params(cfg, 0, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    n_par = sum(p.numel() for p in params.parameters())
    log(f"engine: llama-7b-paper {cfg.n_layers} layers d={cfg.d_model} "
        f"bf16 params={n_par} ({n_par * 2 / 1e9:.2f} GB) init "
        f"{time.monotonic() - t0:.1f}s")
    trace = build_trace(cfg, 8, (64, 128), 16, seed=0)
    ranks = {aid: int(aid.rsplit("-r", 1)[1]) for aid, _, _ in trace}
    weights = adapter_weights(cfg, ranks, dtype=torch.bfloat16, device=dev,
                              seed=3)
    kern = {"padded": sgmv.sgmv_fused_blocks,
            "bucketed": sgmv.sgmv_multibank_blocks}
    per_launch = len(cfg.lora.targets) * cfg.n_layers
    outputs = {}
    # the main path: counts at 0 just before, read just after; the
    # recorder copies the arguments of a few kernel calls for phase 3
    for k in kern.values():
        k.launches = 0
    with MainPathCalls() as rec:
        for mode in ("padded", "bucketed"):
            for db in (1, 4):
                before = {m: k.launches for m, k in kern.items()}
                torch.cuda.reset_peak_memory_stats(dev)
                eng, reqs, s = serve(
                    cfg, params, trace, weights=weights, bank_mode=mode,
                    lora_kernel="sgmv", decode_block=db, max_batch=8,
                    device=dev)
                torch.cuda.synchronize()
                grew = {m: k.launches - before[m] for m, k in kern.items()}
                want = per_launch * (eng.prefill_dispatches
                                     + eng.decode_iterations)
                assert all(len(r.output) == 16 for r in reqs), \
                    [len(r.output) for r in reqs]
                assert all(0 <= t < cfg.vocab_size for r in reqs
                           for t in r.output)
                other = "bucketed" if mode == "padded" else "padded"
                assert grew[mode] == want and grew[other] == 0, \
                    (grew, want)
                outputs[(mode, db)] = [r.output for r in reqs]
                log(f"engine mode={mode} decode_block={db} finished="
                    f"{s['finished']}/8 prefill_groups="
                    f"{eng.prefill_dispatches} decode_steps="
                    f"{eng.decode_iterations} launches={grew[mode]}"
                    f" p50_ttft_ms={s['p50_ttft'] * 1e3:.2f}"
                    f" p95_ttft_ms={s['p95_ttft'] * 1e3:.2f}"
                    f" mean_tbt_ms={s['mean_tbt'] * 1e3:.3f}"
                    f" decode_tok_s={s['decode_tok_s']:.1f}"
                    f" wall_s={s['wall_s']:.3f} max_mem_gb="
                    f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f}")
                del eng
    launches = {m: k.launches for m, k in kern.items()}
    first = outputs[("padded", 1)]
    for key, out in outputs.items():
        assert out == first, f"tokens of {key} differ from padded/1"
    log(f"engine: all 4 runs emit the same tokens; first request "
        f"{first[0]}")
    del params
    torch.cuda.empty_cache()
    return launches, rec.calls


def phase_parity(dev):
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import adapter_weights, build_trace, serve
    from repro_torch.models import model as M
    cfg = dataclasses.replace(get_config("llama-7b-paper"), n_layers=2)
    params = M.init_params(cfg, 1, dtype=torch.float32, device=dev)
    trace = build_trace(cfg, 5, (24, 40), 8, seed=1)
    ranks = {aid: int(aid.rsplit("-r", 1)[1]) for aid, _, _ in trace}
    weights = adapter_weights(cfg, ranks, dtype=torch.float32, device=dev,
                              seed=4)
    outs, logits = {}, {}
    for mode in ("padded", "bucketed"):
        for kernel in ("sgmv", "einsum"):
            eng, reqs, _ = serve(cfg, params, trace, weights=weights,
                                 bank_mode=mode, lora_kernel=kernel,
                                 max_batch=8, device=dev)
            outs[(mode, kernel)] = [r.output for r in reqs]
            toks = torch.tensor([p for _, p, _ in trace if len(p) == 24],
                                device=dev)
            gi = torch.tensor([eng.lora_bank.index(a) for a, p, _ in trace
                               if len(p) == 24], dtype=torch.int32,
                              device=dev)
            lg, _ = M.prefill(cfg, params, toks, bank=eng.bank,
                              lora_idx=eng.lora_bank.lora_idx(gi),
                              lora_kernel=kernel)
            assert torch.isfinite(lg).all()
            logits[(mode, kernel)] = lg
    ref = logits[("padded", "einsum")]
    for key, lg in logits.items():
        err = (lg - ref).abs().max().item()
        log(f"parity fp32 2 layers {key}: prefill logits max abs diff vs "
            f"padded/einsum {err:.3e}; tokens equal: "
            f"{outs[key] == outs[('padded', 'einsum')]}")
        assert err <= 1e-3, (key, err)
        assert outs[key] == outs[("padded", "einsum")], key
    delta = (logits[("padded", "einsum")] - M.prefill(
        cfg, params, toks)[0]).abs().max().item()
    log(f"parity: the LoRA delta moves the logits by {delta:.3e}")
    assert delta > 1e-3
    del params
    torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = gpu_line()
    log(f"device: {name} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | TF32 off (matmul and cuDNN)")
    t0 = time.monotonic()
    build.build(verbose=True)            # the ptxas report, when it builds
    build.load_library()
    log(f"build: {build.library_path().name} in "
        f"{time.monotonic() - t0:.1f}s")

    t0 = time.monotonic()
    launches, calls = phase_engine(dev)
    log(f"phase engine: {time.monotonic() - t0:.1f}s")
    t0 = time.monotonic()
    kres = phase_kernels(dev, calls)
    log(f"phase kernels: {time.monotonic() - t0:.1f}s")
    t0 = time.monotonic()
    phase_parity(dev)
    log(f"phase parity: {time.monotonic() - t0:.1f}s")

    src = "src/repro_torch/kernels/csrc/sgmv.cu"
    rows = []
    for kname, replaces, mode in (
            ("sgmv_fused_blocks", "src/repro/kernels/sgmv.py:167", "padded"),
            ("sgmv_multibank_blocks", "src/repro/kernels/sgmv.py:319",
             "bucketed")):
        r = kres[(kname, "decode", torch.bfloat16)]   # as a decode step ran
        rows.append({"name": kname, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches[mode],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"], "library_ms": None})
        assert launches[mode] > 0, f"{kname} never launched on the main path"
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
