"""Dry-run of every (architecture x input shape) case on the production
meshes, with no card and no memory: each case's rank program runs on
``meta`` tensors (``launch/specs.py``) under a FLOP counter, and its
argument bytes, collective bytes and roofline terms are written one JSON
file a case, the keys the JAX package's ``launch/dryrun.py`` writes and
``launch/report.py`` renders.

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch all]
        [--shape all] [--mesh single|multi|both] [--out DIR]
        [--case-timeout S] [--config full|smoke] [--part NAME]

The meshes are the JAX ones' chip counts: ``single`` (dp 16, tp 16),
``multi`` (dp 32, tp 16) ("data", and "pod" x "data", as dp; "model" as
tp). The port runs one process a rank, so a case is rank 0's program:
its slice of the weights, cache and bank, its rows of the batch
(``specs.build_case``).

What each key measures in the port:

* ``hlo_flops`` — ``flop_count`` of rank 0's program times the ranks
  (dp x tp, or dp for a train replica): 2 M N K an ``mm``/``bmm`` (what
  ``einsum`` lowers to; ``addmm``/``baddbmm`` add M N), one FLOP an
  output element of every other compute op, none for shape-only ops (the
  JAX ``_SHAPE_ONLY_PRIMS``: views, copies, casts, gathers, scatters,
  pads, sorts, concatenations). A kernel counts its own work, not its
  plain version's (B5, the operator ``repro_torch.flash_mha``: 4 hd a
  kept pair). The token-serial scans are trip-aware: a scan of
  ``models/ssm.py:token_scan`` runs as one step over S x B rows, the
  operations of its S steps, forward and backward. Work replicated across ranks (norms at tp, every row where dp
  does not divide the batch) counts on every rank that does it.
* ``hlo_bytes`` — rank 0's memory traffic in eager mode: each compute or
  copy op reads its inputs and writes its outputs once (an expanded input
  counts its stored elements), a kernel its inputs and output.
* ``memory.argument_bytes`` — params + bank + cache (+ the AdamW moments
  and the batch in ``train_4k``) + the small integer arguments on rank 0;
  ``memory.output_bytes`` the program's outputs; ``memory.temp_bytes`` is
  not measured (eager: no compiled temp buffers), null.
* ``collective_bytes`` / ``collectives`` — rank 0's collectives through
  ``models/common.py``'s ``all_reduce_``, ``all_gather_`` and
  ``all_to_all_``, each call's result bytes, by kind (the JAX
  ``collective_bytes``: a collective's result, trip counts included; an
  eager loop over layers counts its trips itself). No process group is
  made: the rank's group is a stand-in that logs and sends nothing
  (``specs.CollectiveLog``).
* ``compile_s`` — the case's build-and-count seconds.
* ``t_compute`` = rank FLOPs / the part's peak for the case's type (bf16);
  ``t_memory`` = ``hlo_bytes`` / its HBM rate; ``t_collective`` =
  ``collective_bytes`` over its peer link: the data sheet's NVLink figure
  for the part, the counterpart of the JAX model's "one ICI link"
  (``launch/mesh.py:roofline``; ``--part`` names a part when no card is
  present).

A width the port refuses at the case's tp (``sharding._refuse``, ROADMAP
C5) makes the case "refused (C5)": its JSON goes under ``OUT/refused/``,
where ``report.py`` does not read, and the run still passes. A train case
at tp > 1 is what the port runs: one replica at tp = 1, its row says so.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import signal
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import (ASSIGNED_ARCH_IDS, INPUT_SHAPES, get_config,
                                 get_smoke_config)
from repro_torch.kernels.flash import kept_pairs
from repro_torch.models import ssm

from .mesh import roofline, roofline_of
from .specs import build_case, effective_config

MESHES = {"single": (16, 16), "multi": (32, 16)}

_SHAPE_ONLY = {
    "view", "_unsafe_view", "reshape", "permute", "transpose", "t",
    "expand", "slice", "select", "unsqueeze", "squeeze", "alias", "detach",
    "split", "split_with_sizes", "unbind", "as_strided", "lift_fresh",
    "cat", "stack", "clone", "copy_", "_to_copy", "constant_pad_nd",
    "index", "index_select", "index_put", "index_put_", "gather",
    "scatter", "scatter_", "scatter_add", "scatter_add_", "embedding",
    "where", "masked_fill", "masked_fill_", "sort", "topk", "flip",
    "select_backward", "slice_backward", "embedding_dense_backward",
    "empty", "empty_like", "empty_strided", "new_empty", "new_zeros",
    "new_full", "new_ones", "zeros", "zeros_like", "ones", "ones_like",
    "full", "full_like", "arange", "scalar_tensor", "fill_", "zero_",
    "_local_scalar_dense",
}
# ops that move no bytes either: views and factories
_NO_TRAFFIC = {
    "view", "_unsafe_view", "reshape", "permute", "transpose", "t",
    "expand", "slice", "select", "unsqueeze", "squeeze", "alias", "detach",
    "split", "split_with_sizes", "unbind", "as_strided", "lift_fresh",
    "empty", "empty_like", "empty_strided", "new_empty", "arange",
    "scalar_tensor",
}


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)


def _read_bytes(t) -> int:
    """An input's bytes read: its elements, at most its storage."""
    return min(t.numel() * t.element_size(), t.untyped_storage().nbytes())


def _dot_flops(name: str, args, out) -> float:
    """2 M N K (+ M N for the added term) of a product op."""
    if name in ("mm", "bmm"):
        a = args[0]
        return 2.0 * out.numel() * a.shape[-1]
    if name in ("addmm", "baddbmm"):
        a = args[1]
        return 2.0 * out.numel() * a.shape[-1] + out.numel()
    return None


def _kernel_flops(name: str, args):
    """A kernel operator's own work (B5: 4 hd a kept pair); None for an
    op that is not a kernel's."""
    if name == "flash_mha":
        q, k, _, causal = args
        B, H, Sq, hd = q.shape
        return 4.0 * hd * B * H * kept_pairs(Sq, k.shape[2], causal)
    return None


class FlopCounter(TorchDispatchMode):
    """Counts the FLOPs and the memory traffic of every op dispatched
    while it is active, by op name."""

    def __init__(self):
        super().__init__()
        self.by_op = {}
        self.hbm_bytes = 0

    @property
    def total(self) -> float:
        return float(sum(self.by_op.values()))

    @property
    def dots(self) -> float:
        """The products' FLOPs (``mm``, ``bmm``, ``addmm``, ``baddbmm``)."""
        return float(sum(v for k, v in self.by_op.items()
                         if k in ("mm", "bmm", "addmm", "baddbmm")))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if name not in _NO_TRAFFIC:
            self.hbm_bytes += sum(_read_bytes(t) for t in _tensors(args))
            self.hbm_bytes += sum(t.numel() * t.element_size()
                                  for t in _tensors(out))
        if name in _SHAPE_ONLY:
            return out
        flops = _kernel_flops(name, args)
        if flops is None:
            flops = _dot_flops(name, args, out)
        if flops is None:
            flops = float(sum(t.numel() for t in _tensors(out)))
        if flops:
            self.by_op[name] = self.by_op.get(name, 0.0) + flops
        return out


@contextlib.contextmanager
def _scans_in_one_step():
    """While open, a token-serial scan on meta tensors
    (``models/ssm.py:token_scan``) runs as one step over S x B rows, the
    carry broadcast to each: the operations of its S steps, forward and
    backward, and its outputs' shapes (meta tensors hold no values).
    Stepping S times on meta would dispatch every op of the step S times
    a layer (32 768 for a long prefill)."""
    loop = ssm.token_scan

    def scan(step, carry, xs):
        if not xs[0].is_meta:
            return loop(step, carry, xs)
        B, S = xs[0].shape[:2]
        rows = carry.unsqueeze(0).expand(S, *carry.shape).reshape(
            S * B, *carry.shape[1:])
        rows, y = step(rows, *(x.transpose(0, 1).reshape(S * B, *x.shape[2:])
                               for x in xs))
        return (y.reshape(S, B, *y.shape[1:]).transpose(0, 1),
                rows.reshape(S, B, *rows.shape[1:])[-1])

    ssm.token_scan = scan
    try:
        yield
    finally:
        ssm.token_scan = loop


def flop_count(fn, *args, **kwargs):
    """(the ``FlopCounter`` after ``fn(*args, **kwargs)``, its result)."""
    counter = FlopCounter()
    with counter, _scans_in_one_step():
        out = fn(*args, **kwargs)
    return counter, out


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6*N*D (train) / 2*N*D (inference), N = active params."""
    n = cfg.n_params()
    if cfg.moe is not None:
        e = cfg.moe
        expert_p = 3 * cfg.d_model * e.d_ff_expert * cfg.n_layers
        n = n - e.n_experts * expert_p + e.top_k * expert_p
    tokens = shape.global_batch * (shape.seq_len if shape.mode != "decode"
                                   else 1)
    mult = 6 if shape.mode == "train" else 2
    return float(mult) * n * tokens


def run_case(arch: str, shape_name: str, mesh, roof, dtype=torch.bfloat16,
             config=get_config):
    """One case's result dict (the JAX keys, their port meaning in the
    module docstring); ``status`` is "ok" or "refused (C5)". ``config``
    maps the arch id to its config (``get_smoke_config``: the reduced
    widths)."""
    cfg = config(arch)
    shape = INPUT_SHAPES[shape_name]
    dp, tp = mesh
    t0 = time.time()
    case = build_case(cfg, shape_name, mesh, dtype, device="meta")
    base = {"arch": arch, "shape": shape_name, "mesh": f"{dp}x{tp}",
            "chips": dp * tp, "dp": dp, "tp": tp, "rows": case.rows}
    if case.refused:
        return dict(base, status="refused (C5)", reason=case.refused)
    grad = torch.enable_grad() if shape.mode == "train" else torch.no_grad()
    with grad:
        counter, out = flop_count(case.fn, *case.args)
    t_build = time.time() - t0
    ranks = dp * case.tp
    flops_rank = counter.total
    coll = dict(case.collectives.bytes) if case.collectives else {}
    coll_total = float(sum(coll.values()))
    arg_b = float(sum(case.arg_bytes.values()))
    out_b = float(sum(t.numel() * t.element_size()
                      for t in _tensors(out)))
    mf = model_flops(effective_config(cfg, shape_name), shape)
    flops = flops_rank * ranks
    result = dict(base, **{
        "status": "ok",
        "case_tp": case.tp,
        "note": case.note,
        "compile_s": round(t_build, 1),
        "hlo_flops": flops,                       # global: rank x ranks
        "rank_flops": flops_rank,
        "hlo_bytes": float(counter.hbm_bytes),    # rank 0's traffic
        "collective_bytes": coll_total,
        "collectives": coll,
        "collective_calls": dict(case.collectives.calls)
        if case.collectives else {},
        "model_flops": mf,
        "useful_flops_frac": mf / flops if flops else None,
        "memory": {
            "argument_bytes": arg_b,
            "arguments": dict(case.arg_bytes),
            "output_bytes": out_b,
            "temp_bytes": None,
            "generated_code_bytes": None,
        },
        "roofline": {"part": roof.name, "source": roof.source,
                     "power_limit": roof.power_limit,
                     "hbm_bytes_per_s": roof.hbm_bytes_per_s,
                     "peak_flops": roof.flops(dtype),
                     "link_bytes_per_s": roof.link_bytes_per_s,
                     "link": roof.link},
        # roofline terms (seconds), rank 0's:
        #   compute: its FLOPs at the part's peak for the type
        #   memory:  its traffic at the HBM rate
        #   collective: its collective bytes over the peer link
        "t_compute": flops_rank / roof.flops(dtype),
        "t_memory": counter.hbm_bytes / roof.hbm_bytes_per_s,
        "t_collective": coll_total / roof.link_bytes_per_s,
    })
    terms = {"compute": result["t_compute"], "memory": result["t_memory"],
             "collective": result["t_collective"]}
    result["bottleneck"] = max(terms, key=terms.get)
    return result


def part_roofline(part=None):
    """The roofline of the card, or of the part named (no card here)."""
    if part:
        return roofline_of(part)
    if not torch.cuda.is_available():
        raise SystemExit("no card: name the part whose roofline the "
                         "dry-run uses, e.g. --part 'NVIDIA H100 80GB "
                         "HBM3'")
    return roofline("cuda")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default="all",
                    help="arch id, 'all' (assigned), or comma list")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--case-timeout", type=int, default=1800,
                    help="seconds per (arch, shape, mesh) case")
    ap.add_argument("--config", default="full", choices=["full", "smoke"],
                    help="the configs' published widths, or the reduced "
                         "ones (a quick check)")
    ap.add_argument("--part", default=None,
                    help="the part whose published peaks to use (default: "
                         "the card's)")
    args = ap.parse_args(argv)
    roof = part_roofline(args.part)
    config = get_config if args.config == "full" else get_smoke_config

    class CaseTimeout(Exception):
        pass

    def _alarm(signum, frame):
        raise CaseTimeout()

    signal.signal(signal.SIGALRM, _alarm)

    archs = (ASSIGNED_ARCH_IDS if args.arch == "all"
             else args.arch.split(","))
    shapes = (list(INPUT_SHAPES) if args.shape == "all"
              else args.shape.split(","))
    meshes = {"single": ["single"], "multi": ["multi"],
              "both": ["single", "multi"]}[args.mesh]

    os.makedirs(os.path.join(args.out, "refused"), exist_ok=True)
    failures, refused = [], 0
    for arch in archs:
        for shape in shapes:
            for m in meshes:
                tag = f"{arch}__{shape}__{m}"
                path = os.path.join(args.out, tag + ".json")
                if os.path.exists(path):
                    print(f"SKIP {tag} (exists)")
                    continue
                try:
                    signal.alarm(args.case_timeout)
                    res = run_case(arch, shape, MESHES[m], roof,
                                   config=config)
                    signal.alarm(0)
                except Exception as e:  # noqa: BLE001 -- a case fails alone
                    signal.alarm(0)
                    failures.append((tag, repr(e)[:300]))
                    print(f"FAIL {tag}: {repr(e)[:300]}", flush=True)
                    continue
                if res["status"] != "ok":
                    refused += 1
                    path = os.path.join(args.out, "refused", tag + ".json")
                with open(path, "w") as f:
                    json.dump(res, f, indent=1)
                if res["status"] != "ok":
                    print(f"REFUSED {tag}: {res['reason'][:200]}",
                          flush=True)
                    continue
                print(f"OK   {tag}: build+count={res['compile_s']}s "
                      f"bottleneck={res['bottleneck']} "
                      f"tc={res['t_compute']:.3e} "
                      f"tm={res['t_memory']:.3e} "
                      f"tx={res['t_collective']:.3e}", flush=True)
    if failures:
        print(f"\n{len(failures)} failures:")
        for tag, err in failures:
            print(" ", tag, err)
        return 1
    print(f"\nall dry-runs passed ({refused} refused (C5))")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
