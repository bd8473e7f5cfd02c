"""The engine's process layout over a (dp, tp) mesh (the counterpart of the
JAX package's ``launch/mesh.py:make_engine_mesh``).

The JAX engine shards over a ("data", "model") device mesh inside one
program. The port runs one SPMD process per rank instead, ``dp * tp`` of
them in one ``torch.distributed`` world: rank r sits at (r // tp, r % tp),
as the JAX ``Mesh(devices.reshape(dp, tp))`` places device r. The ``tp``
ranks of a row hold 1/tp of the weights, the cache and the bank each and
meet in all-reduces over their tensor-parallel subgroup; the ``dp`` rows
hold the same slices, split the engine's slot batch between them where
dp divides it, and meet in one all-gather of the emitted tokens a decode
dispatch over their data-parallel group. ``make_engine_mesh`` describes
the calling rank as a ``TensorParallel`` that carries its
``DataParallel``; ``spawn`` starts the ranks of one world on this host.

The card's limits and roofline (the counterpart of the JAX module's TPU
constants, ``HBM_BW``, ``ICI_BW``, ``PEAK_FLOPS_BF16`` and
``VMEM_BYTES_PER_CORE``) are read at run time: ``device_limits`` (shared
memory, registers, threads, clusters; the smem analysis checks the
kernels against it) and ``roofline`` (the published peaks of the part
the card names, with its power limit; an unknown part raises).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class DataParallel:
    """The calling process's place in its data-parallel group: the ranks
    of the same tensor-parallel slice, one per mesh row."""
    group: Any            # a torch.distributed ProcessGroup; None at size 1
    rank: int
    size: int


NO_DP = DataParallel(None, 0, 1)


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """The calling process's place in its tensor-parallel group, and (``dp``)
    in its data-parallel group."""
    group: Any            # a torch.distributed ProcessGroup; None at size 1
    rank: int
    size: int
    dp: DataParallel = NO_DP


def _groups(dp: int, tp: int, rank: int):
    """(this rank's tp subgroup, its dp group). Every rank creates every
    group, in the same order, as ``dist.new_group`` requires; a group of
    one rank is None."""
    tp_group = dp_group = None
    for i in range(dp):
        g = dist.new_group(list(range(i * tp, (i + 1) * tp))) \
            if tp > 1 else None
        if rank // tp == i:
            tp_group = g
    for j in range(tp):
        g = dist.new_group(list(range(j, dp * tp, tp))) if dp > 1 else None
        if rank % tp == j:
            dp_group = g
    return tp_group, dp_group


def make_engine_mesh(dp: int = 1, tp: int = 1, *,
                     device="cuda") -> TensorParallel:
    """The calling rank of a (dp, tp) engine layout. ``dp = tp = 1`` is the
    single-device engine: no process group is needed or used. Otherwise
    it needs an initialised default group of exactly ``dp * tp``
    processes (``spawn``); on ``device="cuda"`` the rank's current card
    becomes ``rank % cards`` (ranks may share a card over gloo)."""
    if dp < 1 or tp < 1:
        raise ValueError(f"mesh ({dp}, {tp}) must be positive")
    dev = resolve_device(device)
    n = dp * tp
    if n == 1:
        return TensorParallel(None, 0, 1)
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            f"mesh ({dp}, {tp}) needs an initialised torch.distributed "
            f"default process group of {n} ranks (see "
            "repro_torch.launch.mesh.spawn)")
    if dist.get_world_size() != n:
        raise ValueError(f"mesh ({dp}, {tp}) needs {n} ranks but the "
                         f"process group has {dist.get_world_size()}")
    rank = dist.get_rank()
    if dev.type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    tp_group, dp_group = _groups(dp, tp, rank)
    return TensorParallel(tp_group, rank % tp, tp,
                          DataParallel(dp_group, rank // tp, dp))


def _rank_main(rank: int, fn: Callable, world: int, backend: str,
               init_file: str, args: tuple) -> None:
    # one intra-op thread a rank, as torchrun sets: ranks that share a
    # host's cores and spin in their thread pools starve each other's
    # collectives, which makes CPU ranks many times slower
    torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, *, backend: str = "gloo", init_file,
          args: tuple = (), join: bool = True):
    """Run ``fn(rank, *args)`` in ``world`` fresh processes (the "spawn"
    start method, so a parent that has started CUDA may call it), each
    inside a default process group of ``backend`` that meets at
    ``init_file`` (a path that must not exist yet; no TCP port), with one
    intra-op CPU thread. ``fn`` and ``args`` are pickled, so ``fn`` must
    be importable from a module. Returns when every rank has ended;
    raises if one failed. With ``join=False`` returns the processes'
    context at once (``torch.multiprocessing.ProcessContext``)."""
    return torch.multiprocessing.start_processes(
        _rank_main, args=(fn, world, backend, str(init_file), tuple(args)),
        nprocs=world, join=join, start_method="spawn")


# ---------------------------------------------------------------------------
# The card's limits and roofline (the counterpart of the JAX package's TPU
# constants in its ``launch/mesh.py``)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DeviceLimits:
    """What one card allows a kernel, read from the card: by
    ``torch.cuda.get_device_properties`` and the kernel library's
    ``device_limits_query`` (``cudaDeviceGetAttribute``)."""
    name: str
    capability: tuple             # (major, minor)
    sm_count: int
    total_memory: int             # bytes
    smem_per_block_optin: int     # dynamic + static, after the opt-in
    smem_per_sm: int
    smem_reserved_per_block: int  # the runtime's own share of each block
    regs_per_sm: int
    regs_per_block: int
    regs_per_thread: int          # the architecture's cap (255)
    threads_per_sm: int
    max_cluster: int              # blocks, non-portable sizes allowed


# the fields ``device_limits_query`` fills, in its order
_QUERY_FIELDS = ("sm_count", "smem_per_block_optin", "smem_per_sm",
                 "smem_reserved_per_block", "regs_per_sm", "regs_per_block",
                 "threads_per_sm", "max_cluster")
REGS_PER_THREAD = 255             # every compute capability from 3.5


def device_limits(device="cuda") -> DeviceLimits:
    """The limits of ``device`` (a CUDA card: there is no CPU reading)."""
    import ctypes

    from repro_torch.kernels import build
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"device_limits reads a CUDA card, not {dev}")
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    props = torch.cuda.get_device_properties(index)
    out = (ctypes.c_longlong * len(_QUERY_FIELDS))()
    err = build.load_library().device_limits_query(index, out)
    if err:
        raise RuntimeError(f"device_limits_query failed: CUDA error {err}")
    return DeviceLimits(
        name=props.name, capability=(props.major, props.minor),
        total_memory=props.total_memory, regs_per_thread=REGS_PER_THREAD,
        **dict(zip(_QUERY_FIELDS, (int(v) for v in out))))


@dataclasses.dataclass(frozen=True)
class Roofline:
    """A part's published peaks: HBM bytes/s, FLOP/s by type (dense, no
    sparsity; fp32 on the CUDA cores), the dense TF32 tensor-core rate
    (a kernel that runs fp32 products as 3xTF32 needs three TF32 FLOPs
    a FLOP), and the bytes/s of its peer link, with the source and the
    power limit read beside them (the peaks assume the part's full
    limit)."""
    name: str
    hbm_bytes_per_s: float
    peak_flops: dict              # torch dtype -> FLOP/s
    tf32_flops: float             # dense TF32 on the tensor cores
    link_bytes_per_s: float
    link: str                     # what the link figure is
    source: str
    power_limit: str = ""         # nvidia-smi's name, power.limit line

    def flops(self, dtype) -> float:
        return self.peak_flops[dtype]


# Published peaks by the name the card reports. The H100 SXM part:
# NVIDIA's H100 data sheet, as the on-chip measurement notes give it.
PARTS = {
    "NVIDIA H100 80GB HBM3": Roofline(
        name="NVIDIA H100 80GB HBM3", hbm_bytes_per_s=3.35e12,
        peak_flops={torch.bfloat16: 989e12, torch.float16: 989e12,
                    torch.float32: 67e12},
        tf32_flops=495e12, link_bytes_per_s=900e9,
        link="NVLink 4, the data sheet's 900 GB/s a card (18 links, "
             "both directions)",
        source="NVIDIA H100 Tensor Core GPU data sheet, SXM part"),
}


def roofline_of(name: str) -> Roofline:
    """The published peaks of the part called ``name``; raises on a part
    this table does not hold (it never guesses)."""
    if name not in PARTS:
        raise ValueError(f"no published peaks for {name!r} (known: "
                         f"{sorted(PARTS)}); add the part's data sheet "
                         "figures to launch/mesh.py:PARTS")
    return PARTS[name]


def power_limit_line() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``,
    first card."""
    import subprocess
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def roofline(device="cuda") -> Roofline:
    """The roofline of ``device``: the published peaks of the part whose
    name the card reports, and its power limit as nvidia-smi reads it."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"roofline reads a CUDA card, not {dev}")
    part = roofline_of(torch.cuda.get_device_name(dev))
    return dataclasses.replace(part, power_limit=power_limit_line())
