"""The engine's process layout for tensor parallelism (the counterpart of
the JAX package's ``launch/mesh.py:make_engine_mesh``).

The JAX engine shards over a ("data", "model") device mesh inside one
program. The port runs one SPMD process per tensor-parallel rank instead:
every rank runs the same engine loop on the same requests and holds 1/tp
of the weights, the cache and the bank, and the ranks meet in
``torch.distributed`` all-reduces. ``make_engine_mesh`` describes the
calling rank as a ``TensorParallel``; ``spawn`` starts the ranks of one
world on this host.

Only ``dp = 1`` is ported: data parallelism is ROADMAP queue A item 10.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """The calling process's place in a tensor-parallel group."""
    group: Any            # a torch.distributed ProcessGroup; None at size 1
    rank: int
    size: int


def make_engine_mesh(dp: int = 1, tp: int = 1, *,
                     device="cuda") -> TensorParallel:
    """The calling rank of a (dp, tp) engine layout. ``tp = 1`` is the
    single-device engine: no process group is needed or used. ``tp > 1``
    needs an initialised default group of exactly ``tp`` processes; on
    ``device="cuda"`` the rank's current card becomes ``rank % cards``
    (ranks may share a card over gloo)."""
    if dp != 1:
        raise NotImplementedError(
            f"dp={dp}: only dp = 1 is ported (data parallelism is ROADMAP "
            "queue A item 10)")
    if tp < 1:
        raise ValueError(f"tp={tp} must be positive")
    dev = resolve_device(device)
    if tp == 1:
        return TensorParallel(None, 0, 1)
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            f"tp={tp} needs an initialised torch.distributed default "
            "process group of tp ranks (see repro_torch.launch.mesh.spawn)")
    if dist.get_world_size() != tp:
        raise ValueError(f"tp={tp} but the process group has "
                         f"{dist.get_world_size()} ranks")
    rank = dist.get_rank()
    if dev.type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    return TensorParallel(dist.group.WORLD, rank, tp)


def _rank_main(rank: int, fn: Callable, tp: int, backend: str,
               init_file: str, args: tuple) -> None:
    # one intra-op thread a rank, as torchrun sets: ranks that share a
    # host's cores and spin in their thread pools starve each other's
    # collectives, which makes CPU ranks many times slower
    torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            world_size=tp, rank=rank)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, tp: int, *, backend: str = "gloo", init_file,
          args: tuple = ()) -> None:
    """Run ``fn(rank, *args)`` in ``tp`` fresh processes (the "spawn" start
    method, so a parent that has started CUDA may call it), each inside a
    default process group of ``backend`` that meets at ``init_file`` (a
    path that must not exist yet; no TCP port), with one intra-op CPU
    thread. ``fn`` and ``args`` are pickled, so ``fn`` must be importable
    from a module. Returns when every rank has ended; raises if one
    failed."""
    torch.multiprocessing.start_processes(
        _rank_main, args=(fn, tp, backend, str(init_file), tuple(args)),
        nprocs=tp, join=True, start_method="spawn")
