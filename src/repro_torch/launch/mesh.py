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
