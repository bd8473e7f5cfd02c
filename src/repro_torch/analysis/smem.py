"""Shared memory, registers and spills of the port's CUDA kernels against
the card's limits: the counterpart of the JAX package's
``analysis/vmem.py`` (which checks the Pallas kernels' VMEM against a
TPU core's budget).

**The geometry mirror.** Each kernel instantiation that a launcher can
reach is a ``Launch``: its threads and ``__launch_bounds__`` minimum
blocks an SM, the dynamic shared memory its launcher sets
(``Geo::smem_bytes(split)`` of B1/B2/B3a/B4a, ``smem_bytes(bq, bk, hd)``
and ``tc_smem_bytes(HDP)`` of B5's two kernels) and its static
``__shared__`` bytes (B3b/B4b's tile). The formulas are mirrored here in
Python; every constant they read (``kThreads``, ``kTileThreads``,
``kMaxRank``, ``kMaxSplit``, ``kPad``, the ``Geo`` arguments, ``kTcRows``,
... and each kernel's ``__launch_bounds__``) is parsed from the ``.cu``
text (``parse_constants``), so the mirror cannot drift from the source
unseen; on the card the ``smem-mirror`` rule holds the mirror's bytes
against the library's own (``sgmv_kernel_resources``,
``flash_kernel_resources``).

**The envelope** (``kernel_launches``): every registered config's LoRA
input widths (q, k, v: d_model; o: the heads' width) at tp 1, 2 and 4
(the rank's d slice), each giving the shrink split C that
``kernels/sgmv.py:shrink_split`` picks; B2's block_t 16 (``GeoBank``),
32 and 64 (``GeoWide``); every config's head dim for B5 (its bf16 kernel
padded to 32, 64 or 128; its fp32 kernel at the wrapper's largest tiles,
128 x 128); bf16 and fp32. fp32 is production here (B5's fp32 kernel
serves seamless's encoder, ROADMAP C3), so an fp32 bust is an **error**,
not the JAX pass's warning.

**The limits** come from ``launch/mesh.py:device_limits`` on the card,
the resources (registers, static bytes, spills) from
``cudaFuncGetAttributes`` of each compiled instantiation, the cluster
check from ``sgmv_cluster_occupancy``. On the CPU the pass runs on the
mirror against limits and an attribute table that the caller states
(``analyze_kernels(limits=..., attrs=...)``); nothing reads such a table
in place of the card.

Rules: ``smem-budget`` (dynamic + static above the per-block opt-in),
``smem-occupancy`` (the ``__launch_bounds__`` minimum blocks do not fit
an SM by shared memory, registers or threads), ``reg-spill`` (local
memory > 0: a warning, a spill is slow, not wrong), ``smem-mirror`` (the
mirror's bytes differ from the library's), ``cluster-size`` (the card
holds no cluster of the split, or the split exceeds its largest cluster)
and ``smem-parse`` (a constant the mirror needs is not in the source).
"""
from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Dict, List, Optional, Tuple

from . import Finding, Severity

_SRC_ROOT = os.path.normpath(
    os.path.join(os.path.dirname(__file__), "..", ".."))
CSRC = os.path.join("repro_torch", "kernels", "csrc")
SGMV_CU = os.path.join(CSRC, "sgmv.cu")
FLASH_CU = os.path.join(CSRC, "flash.cu")
TP_DEGREES = (1, 2, 4)
B2_BLOCK_TS = (16, 32, 64)
DTYPES = {2: "bfloat16", 4: "float32"}        # itemsize -> name

# constants each source must define (namespace-level ``constexpr int``)
_SGMV_NAMES = ("kThreads", "kTileT", "kMaxBlockT", "kMaxRank", "kMaxSplit",
               "kKStep", "kTileCols", "kTileThreads")
_FLASH_NAMES = ("kThreads", "kTile", "kTcThreads", "kTcRows", "kTcKeys",
                "kRowPad")
_GEOS = ("GeoFused", "GeoBank", "GeoWide")
# kernel -> (source, C++ template of its instantiation)
_KERNELS = {
    "sgmv_fused_blocks_kernel": "sgmv", "sgmv_multibank_blocks_kernel":
    "sgmv", "sgmv_shrink_kernel": "sgmv", "sgmv_expand_kernel": "sgmv",
    "sgmv_multibank_shrink_kernel": "sgmv",
    "sgmv_multibank_expand_kernel": "sgmv", "flash_mha_kernel": "flash",
    "flash_mha_bf16_kernel": "flash"}

_CONST_RE = re.compile(r"^constexpr int (\w+) = ([^;]+);", re.M)
_TERNARY_RE = re.compile(r"sizeof\(T\)\s*==\s*2\s*\?\s*(\d+)\s*:\s*(\d+)")
_TEMPLATE_CONST_RE = re.compile(
    r"^constexpr int (\w+) = (sizeof\(T\)[^;]+);", re.M)
_GEO_RE = re.compile(r"using (\w+) = Geo<T,([^>]*)>;")
_BOUNDS_RE = re.compile(r"__launch_bounds__\(([^)]*)\)\s+(\w+)\s*\(")


def _int_expr(text: str, names: Dict[str, int]) -> int:
    """An integer expression of literals, known names, + - * / and
    parentheses (C++ integer division)."""
    tree = ast.parse(text.strip(), mode="eval")

    def ev(n):
        if isinstance(n, ast.Expression):
            return ev(n.body)
        if isinstance(n, ast.Constant) and isinstance(n.value, int):
            return n.value
        if isinstance(n, ast.Name) and n.id in names:
            return names[n.id]
        if isinstance(n, ast.BinOp):
            a, b = ev(n.left), ev(n.right)
            if isinstance(n.op, ast.Add):
                return a + b
            if isinstance(n.op, ast.Sub):
                return a - b
            if isinstance(n.op, ast.Mult):
                return a * b
            if isinstance(n.op, (ast.Div, ast.FloorDiv)):
                return a // b
        raise ValueError(f"not an integer expression: {text!r}")
    return ev(tree)


def _by_size(text: str) -> Dict[int, int]:
    """``sizeof(T) == 2 ? a : b`` -> {2: a, 4: b}; a literal -> both."""
    m = _TERNARY_RE.fullmatch(text.strip())
    if m:
        return {2: int(m.group(1)), 4: int(m.group(2))}
    v = int(text.strip())
    return {2: v, 4: v}


@dataclasses.dataclass
class Constants:
    """What the mirror reads of the sources."""
    sgmv: Dict[str, int]
    flash: Dict[str, int]
    pad: Dict[int, int]                    # kPad<T> by itemsize
    fused_min_blocks: Dict[int, int]       # kFusedMinBlocks<T>
    geos: Dict[str, Dict[int, Tuple[int, int, int, int]]]
    bounds: Dict[str, Tuple[str, str]]     # kernel -> (threads, min blocks)


def parse_constants(sgmv_src: str, flash_src: str,
                    path: str = SGMV_CU) -> Tuple[Optional[Constants],
                                                  List[Finding]]:
    """The mirror's constants from the two sources' text; (None,
    ``smem-parse`` findings) when one is missing."""
    findings: List[Finding] = []

    def miss(what, where):
        findings.append(Finding(where, 1, "smem-parse",
                                f"{what} not found in {where}"))

    def consts(src, want, where):
        out: Dict[str, int] = {}
        for m in _CONST_RE.finditer(src):
            try:
                out[m.group(1)] = _int_expr(m.group(2), out)
            except (ValueError, SyntaxError):
                continue
        for n in want:
            if n not in out:
                miss(f"constexpr int {n}", where)
        return out

    flash_path = path.replace("sgmv.cu", "flash.cu")
    sg = consts(sgmv_src, _SGMV_NAMES, path)
    fl = consts(flash_src, _FLASH_NAMES, flash_path)
    templ = {m.group(1): _by_size(m.group(2))
             for m in _TEMPLATE_CONST_RE.finditer(sgmv_src)}
    for n in ("kPad", "kFusedMinBlocks"):
        if n not in templ:
            miss(f"constexpr int {n}<T>", path)
    geos = {}
    for m in _GEO_RE.finditer(sgmv_src):
        args = [a for a in m.group(2).split(",")]
        if len(args) == 4:
            by = [_by_size(a) for a in args]
            geos[m.group(1)] = {s: tuple(b[s] for b in by) for s in (2, 4)}
    for g in _GEOS:
        if g not in geos:
            miss(f"using {g} = Geo<T, rows, stages, cols, chunk>", path)
    bounds = {}
    for src in (sgmv_src, flash_src):
        for m in _BOUNDS_RE.finditer(src):
            parts = [p.strip() for p in m.group(1).split(",")]
            bounds[m.group(2)] = (parts[0], parts[1] if len(parts) > 1
                                  else "1")
    for k, where in _KERNELS.items():
        if k not in bounds:
            miss(f"__launch_bounds__ of {k}",
                 path if where == "sgmv" else flash_path)
    if findings:
        return None, findings
    return Constants(sg, fl, templ["kPad"], templ["kFusedMinBlocks"], geos,
                     bounds), []


def _cdiv(a: int, b: int) -> int:
    return (a + b - 1) // b


def _round4(n: int) -> int:
    return (n + 3) // 4 * 4


def geo_smem(c: Constants, geo: str, itemsize: int, split: int) -> int:
    """``Geo::smem_bytes(split)``: the fp32 partial (rows, kMaxRank), this
    block's reduce share, x's widened chunk, and the ring of T."""
    rows, stages, _cols, chunk = c.geos[geo][itemsize]
    h = rows * c.sgmv["kMaxRank"]
    slot = chunk * c.sgmv["kMaxRank"] + rows * chunk
    return 4 * (h + _round4(_cdiv(h, split)) + rows * (chunk + 4)) + \
        itemsize * stages * slot


def expand_static(c: Constants, itemsize: int) -> int:
    """B3b/B4b's ``__shared__ raw[...]``: the h tile and B's tile."""
    pad = c.pad[itemsize]
    return itemsize * (c.sgmv["kMaxBlockT"] * (c.sgmv["kMaxRank"] + pad) +
                       c.sgmv["kMaxRank"] * (c.sgmv["kTileCols"] + pad))


def flash_fp32_smem(bq: int, bk: int, hd: int) -> int:
    """``smem_bytes(bq, bk, hd)``: q, a k or v tile, the scores, m, l."""
    return 4 * (bq * (hd + 1) + bk * (hd + 1) + bq * (bk + 1) + 3 * bq)


def flash_bf16_smem(c: Constants, hdp: int) -> int:
    """``tc_smem_bytes(HDP)``: the q tile, two k and two v tiles."""
    return 2 * (c.flash["kTcRows"] + 4 * c.flash["kTcKeys"]) * \
        (hdp + c.flash["kRowPad"])


@dataclasses.dataclass(frozen=True)
class Launch:
    """One kernel instantiation at one launch geometry."""
    kid: str                   # B1 ... B5
    kernel: str                # the C++ kernel
    instance: str              # its template arguments
    itemsize: int
    threads: int
    min_blocks: int
    dynamic: int               # bytes the launcher sets
    static: int                # __shared__ bytes
    split: Optional[int] = None     # cluster size
    block_t: int = 16
    hd: int = 0
    query: Tuple[int, ...] = ()     # the library query's arguments

    @property
    def key(self) -> str:
        return f"{self.kid} {self.kernel}<{self.instance}>"


def _bound(c: Constants, kernel: str, itemsize: int) -> Tuple[int, int]:
    threads, minb = c.bounds[kernel]
    names = dict(c.sgmv if kernel.startswith("sgmv") else c.flash)
    names["kFusedMinBlocks"] = c.fused_min_blocks[itemsize]
    minb = minb.replace("<T>", "")
    return _int_expr(threads, names), _int_expr(minb, names)


def config_space():
    """(the shrink splits by itemsize over every config's LoRA input
    width at tp 1, 2 and 4; every config's head dim)."""
    import torch

    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.kernels.sgmv import shrink_split
    widths, hds = set(), set()
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        w = [cfg.d_model]
        if cfg.n_heads:
            hd = cfg.resolved_head_dim
            hds.add(hd)
            w.append(cfg.n_heads * (cfg.mla.v_head_dim if cfg.mla else hd))
        for tp in TP_DEGREES:
            widths.update(x // tp for x in w if x % tp == 0)
    splits = {size: sorted({shrink_split(d, dt) for d in widths})
              for size, dt in ((2, torch.bfloat16), (4, torch.float32))}
    return splits, sorted(hds)


def kernel_launches(c: Constants, splits: Dict[int, List[int]],
                    head_dims: List[int]) -> List[Launch]:
    """Every instantiation the launchers reach over the envelope."""
    out: List[Launch] = []
    tile = c.flash["kTile"]
    for size in (2, 4):
        t = "bf16" if size == 2 else "float"
        code = 1 if size == 2 else 0

        def cluster(kid, kernel, geo, inst, split, kidx, bt=16):
            th, mb = _bound(c, kernel, size)
            out.append(Launch(kid, kernel, inst, size, th, mb,
                              geo_smem(c, geo, size, split), 0, split, bt,
                              query=(kidx, code, split, bt)))
        for split in splits[size]:
            cluster("B1", "sgmv_fused_blocks_kernel", "GeoFused", t, split, 0)
            cluster("B2", "sgmv_multibank_blocks_kernel", "GeoBank",
                    f"GeoBank<{t}>", split, 1, 16)
            for bt in B2_BLOCK_TS[1:]:
                cluster("B2", "sgmv_multibank_blocks_kernel", "GeoWide",
                        f"GeoWide<{t}>", split, 1, bt)
            cluster("B3a", "sgmv_shrink_kernel", "GeoFused", t, split, 2)
            cluster("B4a", "sgmv_multibank_shrink_kernel", "GeoBank", t,
                    split, 4)
        for kid, kernel, kidx in (("B3b", "sgmv_expand_kernel", 3),
                                  ("B4b", "sgmv_multibank_expand_kernel",
                                   5)):
            th, mb = _bound(c, kernel, size)
            out.append(Launch(kid, kernel, t, size, th, mb, 0,
                              expand_static(c, size),
                              query=(kidx, code, 1, 16)))
    th, mb = _bound(c, "flash_mha_kernel", 4)
    head_dims = [hd for hd in head_dims if hd <= tile]   # B5 refuses more
    for hd in head_dims:
        out.append(Launch("B5", "flash_mha_kernel", f"float hd={hd}", 4, th,
                          mb, flash_fp32_smem(tile, tile, hd), 0, hd=hd,
                          query=(0, hd, tile, tile)))
    th, mb = _bound(c, "flash_mha_bf16_kernel", 2)
    for hdp in sorted({32 if hd <= 32 else 64 if hd <= 64 else 128
                       for hd in head_dims}):
        out.append(Launch("B5", "flash_mha_bf16_kernel", str(hdp), 2, th, mb,
                          flash_bf16_smem(c, hdp), 0, hd=hdp,
                          query=(1, hdp, tile, tile)))
    return out


@dataclasses.dataclass(frozen=True)
class Resources:
    """``cudaFuncGetAttributes`` of one instantiation, and the dynamic
    bytes its launcher sets (None: not read)."""
    regs: int
    static: int
    local: int
    max_threads: int
    dynamic: Optional[int] = None


def _limit(limits, name):
    return limits[name] if isinstance(limits, dict) else \
        getattr(limits, name)


def _regs_per_block(regs: int, threads: int) -> int:
    """Registers a block takes: each warp's allocation rounded up to 256."""
    per_warp = _cdiv(regs * 32, 256) * 256
    return _cdiv(threads, 32) * per_warp


def check_launch(launch: Launch, limits, res: Optional[Resources] = None,
                 clusters: Optional[int] = None,
                 path: str = SGMV_CU) -> List[Finding]:
    """The rules on one launch (module docstring)."""
    f: List[Finding] = []
    what = (f"{launch.key} ({DTYPES[launch.itemsize]}"
            f"{'' if launch.split is None else f', C={launch.split}'}"
            f"{f', block_t={launch.block_t}' if launch.kid == 'B2' else ''})")
    static = res.static if res is not None else launch.static
    smem = launch.dynamic + static
    optin = _limit(limits, "smem_per_block_optin")
    if smem > optin:
        f.append(Finding(path, 1, "smem-budget",
                         f"{what}: {smem} B of shared memory a block "
                         f"(dynamic {launch.dynamic} + static {static}) "
                         f"> the card's per-block opt-in {optin} B"))
    reserved = _limit(limits, "smem_reserved_per_block")
    per_sm = launch.min_blocks * (smem + reserved)
    if per_sm > _limit(limits, "smem_per_sm"):
        f.append(Finding(path, 1, "smem-occupancy",
                         f"{what}: __launch_bounds__ asks {launch.min_blocks}"
                         f" blocks an SM, {per_sm} B of shared memory "
                         f"(with {reserved} B reserved a block) > "
                         f"{_limit(limits, 'smem_per_sm')} B an SM"))
    if launch.min_blocks * launch.threads > _limit(limits, "threads_per_sm"):
        f.append(Finding(path, 1, "smem-occupancy",
                         f"{what}: {launch.min_blocks} blocks of "
                         f"{launch.threads} threads exceed an SM's threads"))
    if res is not None:
        regs = launch.min_blocks * _regs_per_block(res.regs, launch.threads)
        if regs > _limit(limits, "regs_per_sm"):
            f.append(Finding(path, 1, "smem-occupancy",
                             f"{what}: {launch.min_blocks} blocks at "
                             f"{res.regs} registers a thread take {regs} "
                             f"registers > {_limit(limits, 'regs_per_sm')}"
                             f" an SM"))
        if res.local > 0:
            f.append(Finding(path, 1, "reg-spill",
                             f"{what}: {res.local} B of local memory a "
                             f"thread (registers spilled at {res.regs})",
                             Severity.WARNING))
        if res.dynamic is not None and res.dynamic != launch.dynamic:
            f.append(Finding(path, 1, "smem-mirror",
                             f"{what}: the launcher sets {res.dynamic} B "
                             f"of dynamic shared memory, the mirror says "
                             f"{launch.dynamic}"))
        if res.static != launch.static:
            f.append(Finding(path, 1, "smem-mirror",
                             f"{what}: the compiled kernel holds "
                             f"{res.static} B of static shared memory, the "
                             f"mirror says {launch.static}"))
    if launch.split is not None:
        if launch.split > _limit(limits, "max_cluster"):
            f.append(Finding(path, 1, "cluster-size",
                             f"{what}: a cluster of {launch.split} blocks "
                             f"> the card's largest, "
                             f"{_limit(limits, 'max_cluster')}"))
        elif clusters is not None and clusters < 1:
            f.append(Finding(path, 1, "cluster-size",
                             f"{what}: the card holds no cluster of "
                             f"{launch.split} such blocks at once"))
    return f


def card_resources(launches: List[Launch]):
    """({launch key and geometry: Resources}, {...: clusters or None})
    read from the compiled library on the current card."""
    import ctypes

    from repro_torch.kernels import build
    lib = build.load_library()
    res, occ = {}, {}
    for ln in launches:
        out = (ctypes.c_longlong * 5)()
        fn = lib.flash_kernel_resources if ln.kid == "B5" else \
            lib.sgmv_kernel_resources
        err = fn(*ln.query, out)
        if err:
            raise RuntimeError(f"resources of {ln.key}: CUDA error {err}")
        res[ln] = Resources(*(int(v) for v in out))
        if ln.kid in ("B1", "B2"):
            n = ctypes.c_int(-1)
            err = lib.sgmv_cluster_occupancy(
                0 if ln.kid == "B1" else 1, ln.query[1], ln.split,
                ln.block_t, ctypes.byref(n))
            occ[ln] = n.value if err == 0 else 0
    return res, occ


def _read(src_root: str, rel: str) -> str:
    with open(os.path.join(src_root, rel), "r", encoding="utf-8") as f:
        return f.read()


def analyze_kernels(src_root: str = _SRC_ROOT, limits=None, attrs=None,
                    occupancy=None, report=None) -> List[Finding]:
    """The pass. ``limits=None`` reads the card (``device_limits``, each
    instantiation's ``Resources`` and cluster occupancy); otherwise
    ``limits`` (a ``DeviceLimits`` or a dict of its fields) and the
    optional ``attrs`` ({Launch: Resources}) and ``occupancy`` ({Launch:
    clusters}) are the caller's stated tables. ``report(launch,
    resources, limits)`` sees every launch checked."""
    consts, findings = parse_constants(_read(src_root, SGMV_CU),
                                       _read(src_root, FLASH_CU),
                                       os.path.join(src_root, SGMV_CU))
    if consts is None:
        return findings
    launches = kernel_launches(consts, *config_space())
    if limits is None:
        from repro_torch.launch.mesh import device_limits
        limits = device_limits("cuda")
        attrs, occupancy = card_resources(launches)
    for ln in launches:
        path = os.path.join(src_root, FLASH_CU if ln.kid == "B5"
                            else SGMV_CU)
        res = (attrs or {}).get(ln)
        findings += check_launch(ln, limits, res,
                                 (occupancy or {}).get(ln), path)
        if report is not None:
            report(ln, res, limits)
    return findings
