"""The dry-run's stand-ins for every (architecture x input shape) case, the
counterpart of the JAX package's ``launch/specs.py``.

Where the JAX dry-run describes its arguments with ``jax.eval_shape``
(shapes and types, no memory), this one builds them on the ``meta``
device: the port's own ``init_params``, ``build_bank`` and ``init_cache``
run under ``_OnMeta``, which sends every tensor factory to ``meta``, so
the init code draws nothing and holds nothing, at any width. The
``abstract_*`` functions and ``build_case`` take ``device``: "meta" for
the stand-ins (what the dry-run passes),
else real arguments on that device (the card by default; seeded
weights), which ``chip_smoke.py`` uses to hold the dry-run's bytes
against the card's allocator.

Per-rank shapes come from the port's layout, not from the JAX
``PartitionSpec`` tree: a rank of a (dp, tp) mesh holds its tp slice of
the weights (``serving/sharding.py:PARAM_SPLIT``, the kv-head regroup,
the vocabulary split where tp divides V), its heads of the cache and its
co-sharded slice of the bank; the batch splits over dp where dp divides
it (``fit_spec`` on the "data" axis, as the JAX ``_bs``), else every
replica runs every row. Two layouts differ from the JAX dry-run's: its
decode cache shards the *sequence* over "model" (its ``_cache_sharding``,
context-parallel decode), where a port rank holds its kv *heads* over
the whole sequence; and where the JAX ``fit_spec`` replicates a width the
mesh does not divide, the port refuses the config at that tp
(``sharding._refuse``, ROADMAP C5): such a case is "refused (C5)", not a
failure.

Train cases run as the port trains: one replica at tp = 1 (``training/``
is single-device, as the JAX package's ``launch/train.py``), on B / dp
rows where dp divides B.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist
from torch.overrides import TorchFunctionMode

from repro_torch.configs import INPUT_SHAPES, LONG_CONTEXT_WINDOW, InputShape

# Serving dry-runs carry a live LoRA bank (the paper's workload): 8
# adapters padded to rank 64 on every server.
DRYRUN_N_ADAPTERS = 8
DRYRUN_MAX_RANK = 64

_FACTORIES = {torch.empty, torch.zeros, torch.ones, torch.full, torch.rand,
              torch.randn, torch.randint, torch.arange, torch.tensor,
              torch.as_tensor, torch.eye, torch.linspace,
              torch.empty_strided}


class _OnMeta(TorchFunctionMode):
    """Every tensor factory called inside makes a meta tensor, whatever
    device it names (the model's init code names its generator's)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if func in _FACTORIES:
            kwargs["device"] = "meta"
        return func(*args, **kwargs)


def _on(device):
    """(the device the init code is given, the context it runs in)."""
    import contextlib
    if torch.device(device).type == "meta":
        return "cpu", _OnMeta()
    return device, contextlib.nullcontext()


class _Sent(dist._Work):
    def wait(self, timeout=None):
        return True


class CollectiveLog(dist.ProcessGroup):
    """A tensor-parallel rank's stand-in for its process group on meta
    tensors: ``models/common.py``'s collectives call it as they would a
    real group, and it sends nothing; it logs the result bytes of each
    collective, by kind (the JAX dry-run's per-device ``collective_bytes``
    reads the same: a collective's result)."""

    def __init__(self, rank: int, size: int):
        super().__init__(rank, size)
        self.bytes: Dict[str, int] = {}
        self.calls: Dict[str, int] = {}

    def _log(self, kind: str, results) -> "_Sent":
        self.bytes[kind] = self.bytes.get(kind, 0) + sum(
            t.numel() * t.element_size() for t in results)
        self.calls[kind] = self.calls.get(kind, 0) + 1
        return _Sent()

    def allreduce(self, tensors, opts=None):
        return self._log("all-reduce", tensors)

    def allgather(self, outputs, inputs, opts=None):
        return self._log("all-gather", outputs[0])

    def alltoall_base(self, output, input, output_splits, input_splits,
                      opts=None):
        return self._log("all-to-all", [output])

    def getBackendName(self) -> str:
        return "collective-log"


def rank_tp(tp: int, rank: int = 0):
    """The ``TensorParallel`` of one rank of a tp group on meta tensors
    (its group a ``CollectiveLog``); None at tp = 1."""
    from .mesh import TensorParallel
    return None if tp == 1 else TensorParallel(CollectiveLog(rank, tp),
                                               rank, tp)


def _axis_size(mesh, ax) -> int:
    if isinstance(ax, (tuple, list)):
        n = 1
        for a in ax:
            n *= mesh.shape[a]
        return n
    return mesh.shape[ax]


def fit_spec(mesh, spec, shape) -> tuple:
    """Drop sharding on dims the mesh axes don't evenly divide: the JAX
    ``fit_spec`` on a spec given as a tuple (an axis name, a tuple of
    them, or None a dim); ``mesh`` needs only ``.shape`` (axis ->
    size)."""
    dims = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for size, ax in zip(shape, dims):
        if ax is None:
            out.append(None)
        else:
            out.append(ax if size % _axis_size(mesh, ax) == 0 else None)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A (dp, tp) mesh by its axes, all ``fit_spec`` reads."""
    dp: int
    tp: int

    @property
    def shape(self) -> dict:
        return {"data": self.dp, "model": self.tp}

    @property
    def size(self) -> int:
        return self.dp * self.tp


def needs_window(cfg) -> bool:
    """long_500k carve-out: SSM state is O(1); everything attention-bearing
    uses the sliding-window variant."""
    return cfg.family != "ssm"


def effective_config(cfg, shape_name: str):
    if shape_name == "long_500k" and needs_window(cfg):
        return cfg.with_sliding_window(LONG_CONTEXT_WINDOW)
    return cfg


def abstract_params(cfg, dtype=torch.bfloat16, tp: int = 1, rank: int = 0,
                    device="cuda"):
    """One rank's base weights (the whole model at tp = 1): meta stand-ins,
    or seeded weights on a real device (tp = 1 only)."""
    from repro_torch.models import model as M
    dev, ctx = _on(device)
    with ctx:
        return M.init_params(cfg, 0, dtype=dtype, device=dev,
                             tp=rank_tp(tp, rank))


def abstract_bank(cfg, dtype=torch.bfloat16, tp: int = 1, rank: int = 0,
                  device="cuda"):
    """The dry-run's padded bank (``DRYRUN_N_ADAPTERS`` adapters at rank
    ``DRYRUN_MAX_RANK``; the hybrid's one shared-attention layer), this
    rank's co-sharded slice at tp > 1; None for the VLM, whose LoRA
    rides the serving archs, as the JAX dry-run's."""
    if cfg.family == "vlm":
        return None
    from repro_torch.lora.bank import build_bank
    n_layers = 1 if cfg.family == "hybrid" else cfg.n_layers
    ranks = {f"dry{i}": DRYRUN_MAX_RANK for i in range(DRYRUN_N_ADAPTERS)}
    dev, ctx = _on(device)
    with ctx:
        bank = build_bank(cfg, ranks, mode="padded", n_layers=n_layers,
                          dtype=dtype, device=dev)
        if tp > 1:
            from repro_torch.serving.sharding import EngineSharding
            bank = EngineSharding(rank_tp(tp, rank), cfg).shard_bank(bank)
    return bank


def abstract_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
                   tp: int = 1, rank: int = 0, enc_len=None, device="cuda"):
    """One rank's decode cache: its kv heads over ``max_len`` positions."""
    from repro_torch.models import model as M
    dev, ctx = _on(device)
    with ctx:
        return M.init_cache(cfg, batch, max_len, dtype, device=dev,
                            tp=rank_tp(tp, rank), enc_len=enc_len)


def _nbytes(tree) -> int:
    from repro_torch.lora.adapter import bank_nbytes
    if isinstance(tree, torch.nn.Module):
        tree = dict(tree.named_parameters())
    return bank_nbytes(tree)


def _frontend(cfg, batch: int, dtype, device):
    """The VLM's patch or the audio encoder's frame embeddings."""
    if cfg.family == "vlm":
        n = cfg.n_frontend_tokens
    elif cfg.family == "audio":
        n = cfg.encoder.n_frames
    else:
        return None
    return torch.zeros((batch, n, cfg.d_model), dtype=dtype, device=device)


@dataclasses.dataclass
class Case:
    """One rank's program of a dry-run case: ``fn(*args)`` is the rank's
    step; ``held`` every tensor argument by name (the bank and the
    adapter indices ``fn`` closes over among them) and ``arg_bytes`` the
    bytes of each; ``rows`` the batch rows it runs; ``tp`` the
    tensor-parallel size it runs at; ``refused`` why the port does not
    run it (then ``fn`` is None)."""
    fn: Optional[Callable]
    args: tuple
    held: Dict[str, object]
    rows: int
    tp: int
    collectives: Optional[CollectiveLog] = None
    refused: Optional[str] = None
    note: str = ""

    @property
    def arg_bytes(self) -> Dict[str, int]:
        return {k: _nbytes(v) for k, v in self.held.items()}

    def tensors(self) -> list:
        """Every tensor the case holds, once each."""
        from repro_torch.lora.adapter import _leaves
        out = {}
        for v in self.held.values():
            if isinstance(v, torch.nn.Module):
                v = list(v.parameters())
            for t in _leaves(v):
                out[id(t)] = t
        return list(out.values())


def _shape(shape) -> InputShape:
    return INPUT_SHAPES[shape] if isinstance(shape, str) else shape


def build_case(cfg, shape, mesh_shape=(1, 1), dtype=torch.bfloat16,
               device="cuda") -> Case:
    """Rank 0's case of ``cfg`` at ``shape`` (a name of ``INPUT_SHAPES`` or
    an ``InputShape``) on a (dp, tp) mesh: its callable, its arguments
    (on ``device``: "meta" for the stand-ins the dry-run counts on, or
    real tensors on the card at (1, 1)) and their bytes. The serving
    cases take the model's LoRA path on the padded bank's einsum
    (``lora_kernel="einsum"``, the JAX dry-run's), whose products are
    kernel B1's work on every row; an MHA prefill reaches kernel B5."""
    from repro_torch.models import model as M
    shape = _shape(shape)
    cfg = effective_config(cfg, shape.name)
    mesh = MeshShape(*mesh_shape)
    if torch.device(device).type != "meta" and mesh.size > 1:
        raise ValueError("real arguments are built at mesh (1, 1) only; "
                         "a rank of a larger mesh is counted on meta")
    B, S = shape.global_batch, shape.seq_len
    rows = B // mesh.dp if fit_spec(mesh, ("data",), (B,))[0] else B
    tp = 1 if shape.mode == "train" else mesh.tp
    dev, ctx = _on(device)
    try:
        params = abstract_params(cfg, dtype, tp, device=device)
        bank = None if shape.mode == "train" else \
            abstract_bank(cfg, dtype, tp, device=device)
    except ValueError as e:
        if "ROADMAP C5" not in str(e):
            raise
        return Case(None, (), {}, rows, tp, refused=f"refused (C5): {e}")
    tpr = rank_tp(tp)
    log = tpr.group if tpr is not None else None
    held = {"params": params}

    def ints(*shape_):
        with ctx:
            return torch.zeros(shape_, dtype=torch.int32, device=dev)
    with ctx:
        fe = _frontend(cfg, rows, dtype, dev)

    if shape.mode == "train":
        from repro_torch.training import (AdamWConfig, adamw_init,
                                          make_train_step)
        with ctx:
            opt = adamw_init(params)
        batch = {"tokens": ints(rows, S), "labels": ints(rows, S)}
        if fe is not None:
            batch["frontend"] = fe
        held.update(opt=opt, batch=batch)
        note = "" if mesh.tp == 1 else (
            f"a replica at tp 1 (the port trains on one device); the "
            f"mesh's tp {mesh.tp} is not used")
        return Case(make_train_step(cfg, AdamWConfig(), remat=True),
                    (params, opt, batch), held, rows, 1, note=note)

    lora = {}
    if bank is not None:
        lora = {"bank": bank.data, "lora_idx": ints(rows)}
        held.update(bank=bank.data, lora_idx=lora["lora_idx"])

    if shape.mode == "prefill":
        held["tokens"] = ints(rows, S)
        if fe is not None:
            held["frontend"] = fe

        def fn(params, tokens, frontend=None):
            return M.prefill(cfg, params, tokens, frontend=frontend,
                             cache_dtype=dtype, tp=tpr, **lora)
        return Case(fn, (params, held["tokens"], fe), held, rows, tp, log)

    # decode: one new token against a seq_len cache
    cache_len = min(S, cfg.sliding_window) if cfg.sliding_window else S
    enc_len = (cfg.encoder.n_frames if cfg.encoder else
               (cfg.n_frontend_tokens or None))
    held["cache"] = abstract_cache(cfg, rows, cache_len, dtype, tp,
                                   enc_len=enc_len, device=device)
    held["tokens"] = ints(rows)

    def fn(params, cache, tokens):
        return M.decode_step(cfg, params, cache, tokens, tp=tpr, **lora)
    return Case(fn, (params, held["cache"], held["tokens"]), held, rows, tp,
                log)
