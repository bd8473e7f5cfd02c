#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and check it end to end.

    python3 chip_smoke.py          # from the repository root, one card

Phases (any failure raises; the script then exits non-zero):
  1. device  — the card's name and power limit; build every CUDA source
               under ``src/repro_torch/kernels/csrc`` with nvcc, one
               compiler per source, all started together.
  2. engine  — the main path: ``repro_torch.launch.serve.serve`` on
               llama-7b-paper at full width (32 layers, bf16 weights from
               a seed, fp32 cache), padded and bucketed banks, decode
               blocks 1 and 4, 8 requests over 5 adapters with nonzero
               weights, prompts of 64, 128 and 1000 tokens (a group of 2
               at 1000: not a multiple of 128, 8 kv blocks); every request
               gets its 16 tokens, the mode's SGMV kernel launches 4 x 32
               times per prefill group and per decode step, the flash
               kernel B5 32 times per prefill group, all four runs emit the
               same tokens. The arguments of each kernel's and each
               dispatcher's largest (prefill) and smallest (decode) call
               are copied as the path runs.
  3. kernels — B1 ``sgmv_fused_blocks``, B2 ``sgmv_multibank_blocks``, B3a
               ``sgmv_shrink``, B3b ``sgmv_expand`` (on B1's copied
               arguments) and B5 ``flash_mha`` against their plain-torch
               versions on those copies, in bf16 and cast to fp32; times
               from CUDA events with L2 flushed between launches, the
               bound from the bytes and operations the call needs, and for
               B5 the time of ``scaled_dot_product_attention``.
  4. unfused — the path through B3a/B3b: ``sgmv`` and
               ``sgmv_rank_bucketed`` on the engine's own copied dispatcher
               calls, and ``apply_bank_sgmv(fused=False)`` on the engine's
               own banks (4 targets, layer 0, 8 and 512 tokens), each bit
               for bit equal to its fused counterpart; ``bgmv`` against
               its plain version and bit for bit against ``sgmv_fused``.
  5. parity  — fp32, full width, 2 layers: kernel and einsum engines,
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
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

HBM_BYTES_PER_S = 3.35e12             # H100 SXM data sheet
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
BLOCK_T = 16
SGMV_SRC = "src/repro_torch/kernels/csrc/sgmv.cu"
FLASH_SRC = "src/repro_torch/kernels/csrc/flash.cu"
# kernel id -> (wrapper, source, the TPU kernel's pallas_call)
KERNELS = {
    "B1": ("sgmv_fused_blocks", SGMV_SRC, "src/repro/kernels/sgmv.py:167"),
    "B2": ("sgmv_multibank_blocks", SGMV_SRC,
           "src/repro/kernels/sgmv.py:319"),
    "B3a": ("sgmv_shrink", SGMV_SRC, "src/repro/kernels/sgmv.py:72"),
    "B3b": ("sgmv_expand", SGMV_SRC, "src/repro/kernels/sgmv.py:102"),
    "B5": ("flash_mha", FLASH_SRC, "src/repro/kernels/flash.py:103"),
}


def log(*a):
    print(*a, flush=True)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def _wrappers():
    """Kernel id -> the wrapper function, which carries ``launches``."""
    from repro_torch.kernels import flash, sgmv
    return {kid: getattr(flash if kid == "B5" else sgmv, name)
            for kid, (name, _, _) in KERNELS.items()}


# ---------------------------------------------------------------------------
# phase 2 helper: copies of the main path's own calls
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
    """Stands in, while it is entered, for the names under which the port
    calls the kernel wrappers B1/B2 and ``scatter_rows`` (``kernels/
    ops.py``), the dispatchers ``sgmv_fused`` / ``sgmv_bucketed_fused``
    (``lora/batched.py``) and B5 (``models/attention.py``). It forwards
    every call unchanged (the wrappers count their own launches) and keeps
    a copy of the arguments of each one's smallest call (by rows: a decode
    step) and largest (a prefill group), with the ``dest`` that laid out
    the last SGMV call's tokens."""

    def __init__(self):
        from repro_torch.kernels import ops
        from repro_torch.lora import batched
        from repro_torch.models import attention
        self.ops = ops
        self.sites = [(ops, "sgmv_fused_blocks"),
                      (ops, "sgmv_multibank_blocks"),
                      (batched, "sgmv_fused"),
                      (batched, "sgmv_bucketed_fused"),
                      (attention, "flash_mha")]
        self.orig = {}
        self.calls = {}          # (name, layout) -> (args, kwargs, dest)
        self._rows = {}
        self._dest = None

    def __enter__(self):
        scatter = self.ops.scatter_rows
        self.orig[(self.ops, "scatter_rows")] = scatter

        def scatter_rows(x, dest, T_pad):
            self._dest = dest
            return scatter(x, dest, T_pad)
        self.ops.scatter_rows = scatter_rows
        for mod, name in self.sites:
            self.orig[(mod, name)] = getattr(mod, name)
            setattr(mod, name, self._recorder(name, getattr(mod, name)))
        return self

    def __exit__(self, *exc):
        for (mod, name), f in self.orig.items():
            setattr(mod, name, f)

    def _recorder(self, name, fn):
        def call(*args, **kw):
            x = args[0]
            rows = x.shape[0] * x.shape[2] if name == "flash_mha" \
                else x.shape[0]
            for layout, keep in (("decode", lambda a, b: a < b),
                                 ("prefill", lambda a, b: a > b)):
                kept = self._rows.get((name, layout))
                if kept is None or keep(rows, kept):
                    self._rows[(name, layout)] = rows
                    dest = None if self._dest is None else self._dest.clone()
                    self.calls[(name, layout)] = (_copy(args), dict(kw),
                                                  dest)
            return fn(*args, **kw)
        return call


# ---------------------------------------------------------------------------
# phase 3: the kernels against their plain versions, at the main path's
# own calls
# ---------------------------------------------------------------------------


def _sgmv_work(kid, args, dest, item):
    """(bytes, FLOPs) an SGMV call needs: the live rows of its input read
    and of its output written, each used adapter's weights once at the
    rank the call gives it, the block indices, and 2 * r FLOPs per live
    token for each column its weights span (B1/B2: d + d_out, B3a: d,
    B3b: d_out)."""
    x_pad = args[0]
    T = dest.shape[0]
    live = (dest.long() // BLOCK_T).tolist()
    if kid == "B2":
        banks, bkt, row = args[1:]
        rank = [A.shape[-1] for A, _ in banks]
        bkt, row = bkt.tolist(), row.tolist()
        used = {(bkt[i], row[i]): rank[bkt[i]] for i in set(live)}
        tok_r = [rank[bkt[i]] for i in live]
        x_cols, y_cols = x_pad.shape[1], banks[0][1].shape[-1]
        idx_bytes = 8 * len(bkt)
    else:
        W, ba = args[1], args[-1].tolist()
        r = W.shape[1] if kid == "B3b" else W.shape[-1]
        used = {ba[i]: r for i in set(live)}
        tok_r = [r] * T
        x_cols = x_pad.shape[1]
        y_cols = {"B1": args[2].shape[-1], "B3a": r,
                  "B3b": W.shape[-1]}[kid]
        idx_bytes = 4 * len(ba)
    w_cols = {"B3a": x_cols, "B3b": y_cols}.get(kid, x_cols + y_cols)
    byts = (T * (x_cols + y_cols) + sum(used.values()) * w_cols) * item \
        + idx_bytes
    flops = sum(2 * r * w_cols for r in tok_r)
    return byts, flops


def _flash_work(q, item):
    """(bytes, FLOPs) of causal MHA: q, k, v read once and o written once;
    4 * hd FLOPs (q.k and p.v) for each of the S (S + 1) / 2 query-key
    pairs the causal mask keeps in each (batch row, head)."""
    B, H, S, hd = q.shape
    return 4 * B * H * S * hd * item, 4 * hd * B * H * S * (S + 1) // 2


def _time_ms(call, flush, reps=20):
    """Median ms of one call over CUDA events, L2 flushed before each."""
    for _ in range(3):
        call()
    times = []
    for _ in range(reps):
        flush.zero_()
        s, e = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        s.record()
        call()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def _kernel_cases(calls):
    """(kernel id, layout, args, kwargs, dest) for every kernel: B1, B2
    and B5 on their own copied calls, B3a and B3b on B1's (the unfused
    pair's two halves of the same work)."""
    from repro_torch.kernels import sgmv
    cases = []
    for kid in ("B1", "B2"):
        for layout in ("decode", "prefill"):
            args, _, dest = calls[(KERNELS[kid][0], layout)]
            cases.append((kid, layout, args, {"block_t": BLOCK_T}, dest))
    for layout in ("decode", "prefill"):
        (x_pad, A, B, ba), _, dest = calls[("sgmv_fused_blocks", layout)]
        h = sgmv.sgmv_shrink_blocks_ref(x_pad, A, ba, block_t=BLOCK_T)
        cases.append(("B3a", layout, (x_pad, A, ba), {"block_t": BLOCK_T},
                      dest))
        cases.append(("B3b", layout, (h, B, ba), {"block_t": BLOCK_T}, dest))
    args, kw, _ = calls[("flash_mha", "prefill")]
    assert args[0].shape[0] == 2 and args[0].shape[2] == 1000, \
        args[0].shape                       # the 1000-token group
    cases.append(("B5", "prefill", args, kw, None))
    return cases


def phase_kernels(dev, calls):
    """Each kernel wrapper and its plain version on the arguments of the
    main path's own calls (bf16, as the engine ran them, and the same
    tensors cast to fp32); every row of every whole SGMV block, and every
    output of B5, compared."""
    from repro_torch.kernels import flash, sgmv
    wrappers = _wrappers()
    plains = {"B1": sgmv.sgmv_fused_blocks_ref,
              "B2": sgmv.sgmv_multibank_blocks_ref,
              "B3a": sgmv.sgmv_shrink_blocks_ref,
              "B3b": sgmv.sgmv_expand_blocks_ref,
              "B5": flash.flash_mha_plain}
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    results = {}
    for kid, layout, args0, kw, dest in _kernel_cases(calls):
        fn, plain = wrappers[kid], plains[kid]
        for dtype in (torch.bfloat16, torch.float32):
            args = _cast(args0, dtype)
            y = fn(*args, **kw)
            ref = plain(*args, **kw)
            torch.cuda.synchronize()
            item = args[0].element_size()
            if kid == "B5":
                yk, yr = y.float(), ref.float()
                byts, flops = _flash_work(args[0], item)
                shape = f"q={tuple(args[0].shape)}"
                q, k, v = args
                library_ms = _time_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True), flush)
            else:
                n = args[0].shape[0] // BLOCK_T * BLOCK_T
                yk, yr = y[:n].float(), ref[:n].float()
                byts, flops = _sgmv_work(kid, args, dest, item)
                shape = (f"in={tuple(args[0].shape)} blocks={n // BLOCK_T} "
                         f"live_rows={dest.shape[0]}")
                library_ms = None
            assert torch.isfinite(yk).all(), f"{kid}: non-finite output"
            err = (yk - yr).abs().max().item()
            tol = TOL[dtype]
            assert torch.allclose(yk, yr, atol=tol, rtol=tol), \
                f"{kid} {layout} {dtype}: max abs err {err} > tol {tol}"
            ms = _time_ms(lambda: fn(*args, **kw), flush)
            plain_ms = _time_ms(lambda: plain(*args, **kw), flush)
            t_bytes = byts / HBM_BYTES_PER_S * 1e3
            t_ops = flops / PEAK_FLOPS[dtype] * 1e3
            bound_ms, bound_by = max((t_bytes, "bytes"), (t_ops, "operations"))
            lib = "" if library_ms is None else f" library_ms={library_ms:.4f}"
            log(f"kernel {kid} {KERNELS[kid][0]} layout={layout} "
                f"dtype={str(dtype)[6:]} {shape} max_abs_err={err:.3e} "
                f"tol={tol} ms={ms:.4f} plain_ms={plain_ms:.4f}{lib} "
                f"bound_ms={bound_ms:.5f} ({bound_by}: {byts} B, "
                f"{flops} FLOP)")
            results[(kid, layout, dtype)] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)
    del flush
    return results


# ---------------------------------------------------------------------------
# phases 2, 4 and 5: the engine and the unfused path
# ---------------------------------------------------------------------------


def phase_engine(dev):
    from repro_torch.configs import get_config
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
    # prompts 64, 128, 64, 1000 in turn: groups of 4 x 64, 2 x 128 and
    # 2 x 1000 tokens, the last over adapters of ranks 64 and 32
    trace = build_trace(cfg, 8, (64, 128, 64, 1000), 16, seed=0)
    ranks = {aid: int(aid.rsplit("-r", 1)[1]) for aid, _, _ in trace}
    weights = adapter_weights(cfg, ranks, dtype=torch.bfloat16, device=dev,
                              seed=3)
    wrappers = _wrappers()
    sgmv_kid = {"padded": "B1", "bucketed": "B2"}
    per_launch = len(cfg.lora.targets) * cfg.n_layers
    outputs, banks = {}, {}
    # the main path: counts at 0 just before, read just after; the
    # recorder copies the arguments of a few calls for phases 3 and 4
    for k in wrappers.values():
        k.launches = 0
    with MainPathCalls() as rec:
        for mode in ("padded", "bucketed"):
            for db in (1, 4):
                before = {kid: k.launches for kid, k in wrappers.items()}
                torch.cuda.reset_peak_memory_stats(dev)
                eng, reqs, s = serve(
                    cfg, params, trace, weights=weights, bank_mode=mode,
                    lora_kernel="sgmv", decode_block=db, max_batch=8,
                    device=dev)
                torch.cuda.synchronize()
                grew = {kid: k.launches - before[kid]
                        for kid, k in wrappers.items()}
                want = {kid: 0 for kid in wrappers}
                want[sgmv_kid[mode]] = per_launch * (
                    eng.prefill_dispatches + eng.decode_iterations)
                want["B5"] = cfg.n_layers * eng.prefill_dispatches
                assert all(len(r.output) == 16 for r in reqs), \
                    [len(r.output) for r in reqs]
                assert all(0 <= t < cfg.vocab_size for r in reqs
                           for t in r.output)
                assert grew == want, (grew, want)
                assert eng.prefill_dispatches == 3, eng.prefill_dispatches
                outputs[(mode, db)] = [r.output for r in reqs]
                banks[mode] = eng.lora_bank
                log(f"engine mode={mode} decode_block={db} finished="
                    f"{s['finished']}/8 prefill_groups="
                    f"{eng.prefill_dispatches} decode_steps="
                    f"{eng.decode_iterations} launches "
                    f"{sgmv_kid[mode]}={grew[sgmv_kid[mode]]} "
                    f"B5={grew['B5']}"
                    f" p50_ttft_ms={s['p50_ttft'] * 1e3:.2f}"
                    f" p95_ttft_ms={s['p95_ttft'] * 1e3:.2f}"
                    f" mean_tbt_ms={s['mean_tbt'] * 1e3:.3f}"
                    f" decode_tok_s={s['decode_tok_s']:.1f}"
                    f" wall_s={s['wall_s']:.3f} max_mem_gb="
                    f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f}")
                del eng
    launches = {kid: k.launches for kid, k in wrappers.items()}
    first = outputs[("padded", 1)]
    for key, out in outputs.items():
        assert out == first, f"tokens of {key} differ from padded/1"
    log(f"engine: all 4 runs emit the same tokens; first request "
        f"{first[0]}")
    del params
    torch.cuda.empty_cache()
    return cfg, launches, rec.calls, banks


def _plain_bgmv(x, A, B, tok):
    """bgmv's plain version: the block_t = 1 layout through the plain
    shrink and expand."""
    from repro_torch.kernels import ops, sgmv
    Na = A.shape[0]
    dest, ba = ops.prepare_segments(tok, Na, 1)
    x_pad = ops.scatter_rows(x, dest, ops.padded_len(x.shape[0], Na, 1))
    h = sgmv.sgmv_shrink_blocks_ref(x_pad, A, ba, block_t=1)
    return sgmv.sgmv_expand_blocks_ref(h, B, ba, block_t=1)[dest.long()]


def phase_unfused(dev, cfg, calls, banks):
    """The path through B3a/B3b, driven with their counts at 0 just before
    and read just after: the unfused dispatchers on the engine's own
    copied dispatcher calls and on its own banks, each bit for bit equal
    to the fused path."""
    from repro_torch.kernels import ops
    from repro_torch.lora.batched import apply_bank_sgmv
    wrappers = _wrappers()
    b3 = {kid: wrappers[kid] for kid in ("B3a", "B3b")}
    for k in b3.values():
        k.launches = 0
    checked = 0
    for (name, layout), (args, kw, _) in sorted(calls.items()):
        if name == "sgmv_fused":
            y_f = ops.sgmv_fused(*args, **kw)
            y_u = ops.sgmv(*args, **kw)
        elif name == "sgmv_bucketed_fused":
            x, bk, tok, bucket, local = args
            y_f = ops.sgmv_bucketed_fused(*args, **kw)
            y_u = ops.sgmv_rank_bucketed(x, bk, tok, bucket,
                                         adapter_local=local, **kw)
        else:
            continue
        assert torch.equal(y_f, y_u), f"{name} {layout}: unfused differs"
        log(f"unfused: the engine's {name} {layout} call x="
            f"{tuple(args[0].shape)}: unfused == fused bit for bit")
        checked += 1
    g = torch.Generator(device=dev).manual_seed(7)
    for mode, bank in sorted(banks.items()):
        for T in (8, 512):
            x = torch.randn((T, cfg.d_model), generator=g, device=dev
                            ).to(torch.bfloat16)
            tok = torch.randint(0, bank.n_adapters, (T,), generator=g,
                                device=dev, dtype=torch.int32)
            for name in cfg.lora.targets:
                y_f = apply_bank_sgmv(x, bank, name, 0, tok, fused=True)
                y_u = apply_bank_sgmv(x, bank, name, 0, tok, fused=False)
                assert torch.isfinite(y_f.float()).all()
                assert torch.equal(y_f, y_u), (mode, T, name)
                checked += 1
            log(f"unfused: apply_bank_sgmv {mode} bank T={T} targets "
                f"{list(cfg.lora.targets)}: fused=False == fused=True bit "
                "for bit")
    t = banks["padded"].data["q"]
    A, B = t["A"][0], t["B"][0]
    x = torch.randn((8, cfg.d_model), generator=g, device=dev
                    ).to(torch.bfloat16)
    tok = torch.randint(0, A.shape[0], (8,), generator=g, device=dev,
                        dtype=torch.int32)
    y = ops.bgmv(x, A, B, tok)
    ref = _plain_bgmv(x, A, B, tok)
    tol = TOL[torch.bfloat16]
    err = (y.float() - ref.float()).abs().max().item()
    assert torch.allclose(y.float(), ref.float(), atol=tol, rtol=tol), err
    assert torch.equal(y, ops.sgmv_fused(x, A, B, tok))
    log(f"unfused: bgmv (block_t 1) vs plain max abs err {err:.3e} tol "
        f"{tol}; == sgmv_fused (block_t 16) bit for bit")
    launches = {kid: k.launches for kid, k in b3.items()}
    assert all(n > 0 for n in launches.values()), launches
    log(f"unfused: {checked} bitwise pairs; launches {launches}")
    return launches


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
    log(f"build: {build.library_path().name} from "
        f"{sorted(p.name for p in build.CSRC.glob('*.cu'))} in "
        f"{time.monotonic() - t0:.1f}s")

    t0 = time.monotonic()
    cfg, launches, calls, banks = phase_engine(dev)
    log(f"phase engine: {time.monotonic() - t0:.1f}s")
    t0 = time.monotonic()
    kres = phase_kernels(dev, calls)
    log(f"phase kernels: {time.monotonic() - t0:.1f}s")
    t0 = time.monotonic()
    launches.update(phase_unfused(dev, cfg, calls, banks))
    log(f"phase unfused: {time.monotonic() - t0:.1f}s")
    del calls, banks
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    phase_parity(dev)
    log(f"phase parity: {time.monotonic() - t0:.1f}s")

    rows = []
    for kid, (kname, src, replaces) in KERNELS.items():
        # as the path ran it: a decode step's call for the SGMV kernels,
        # the 1000-token prefill group's for B5
        layout = "prefill" if kid == "B5" else "decode"
        r = kres[(kid, layout, torch.bfloat16)]
        assert launches[kid] > 0, f"{kid} {kname} never launched on its path"
        rows.append({"name": kname, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches[kid],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
