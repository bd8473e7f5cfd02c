"""Serving launcher of the PyTorch port: one single-server engine over
``--arch`` (a registered config, ``llama-7b-paper`` by default, as in the
JAX launcher) with adapters of ranks {8, 16, 32, 64, 128}, serving a
batch of requests and printing TTFT / TBT and decode tokens/s.

Example (on the card, full width, bf16 weights from a seed):
  PYTHONPATH=src python -m repro_torch.launch.serve --config full \\
      --bank-mode bucketed --decode-block 4 --requests 16
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch deepseek-v2-lite-16b --servers 2 --bank-mode bucketed

``--config smoke`` serves the reduced config; ``--device cpu`` runs on the
CPU with the kernels' plain versions. Base and adapter weights are random
from ``--seed``, the adapters' B nonzero (a fresh bank's B is zero, which
would make every delta 0). ``--profile`` traces the served run with
``torch.profiler`` and prints device time by kernel, the device's busy
share of the run, and the idle gaps between kernels by size.

``--mesh DP,TP`` serves on an engine over a (DP, TP) mesh of DP x TP
ranks, one process each, spawned here (``launch.mesh.spawn``) and
meeting over ``--backend`` (nccl: one card per rank; gloo: also on the
CPU, or several ranks on one card): TP tensor-parallel ranks a slice of
the weights, DP replicas of them that split the slot batch. Every rank
serves the same trace; rank 0 prints the report. Every family is served
so. Examples, on the CPU:
  PYTHONPATH=src python -m repro_torch.launch.serve --config smoke \
      --device cpu --mesh 1,2 --backend gloo
  PYTHONPATH=src python -m repro_torch.launch.serve --config smoke \
      --device cpu --mesh 2,2 --backend gloo
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch deepseek-v2-lite-16b --config smoke --device cpu \
      --mesh 1,2 --backend gloo
and on one card, two ranks sharing it:
  PYTHONPATH=src python -m repro_torch.launch.serve --mesh 2,1 \
      --backend gloo --bank-mode bucketed --decode-block 4

``--servers N`` serves through the cluster facade instead, as the JAX
package's launcher does: ``LoRAServeCluster`` over an ``EngineBackend`` of
N placement-aware engines that share one copy of the base weights, each
bank holding only its placed adapter subset. The facade runs placement,
phi-routing, the adapter store and demand estimation, and rebalances
while requests are in flight: arrivals spread over ``--duration`` wall
seconds with drifting popularity (low ranks early, high ranks late). The
engines step in turn on one device. With ``--mesh DP,TP`` every
server's engine runs on that mesh (``EngineBackend(mesh_shape=...)``):
DP x TP ranks each hold their slice of every engine, rank 0 runs the
facade and prints the report, and the others follow its calls. Examples,
on the CPU:
  PYTHONPATH=src python -m repro_torch.launch.serve --config smoke \
      --device cpu --servers 2 --requests 12 --duration 2
  PYTHONPATH=src python -m repro_torch.launch.serve --config smoke \
      --device cpu --servers 2 --mesh 1,2 --backend gloo

``--serve HOST:PORT`` serves that cluster (2 servers unless ``--servers``
says otherwise) over the streaming HTTP gateway until SIGTERM instead
(``launch.server.run_gateway``; ``--rate`` and ``--max-inflight`` admit
per tenant). ``--trace-out PATH`` records the span tree of every request
(``.jsonl``: one span a line; otherwise a Perfetto JSON document) and
``--flight-recorder DIR`` dumps the recent spans on SLO violations and
scale events; with either, the report ends with the cost-model drift per
phase: measured spans against the paper's A100 fleet model
(``cluster/costmodel.py``), not a model of the card. With ``--mesh
DP,TP`` the gateway runs on rank 0 over the mesh's engines, and SIGTERM
drains it and stops the other ranks. Examples, on the card:
  PYTHONPATH=src python -m repro_torch.launch.serve --serve 127.0.0.1:0 \
      --trace-out t.json
  PYTHONPATH=src python -m repro_torch.launch.serve --serve 127.0.0.1:0 \
      --mesh 1,2 --backend gloo
"""
from __future__ import annotations

import argparse
import os
import random
import signal
import tempfile
import time
import weakref
import zlib
from pathlib import Path

import torch

from repro_torch.cluster import NetworkModel
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core import POLICIES, AdapterInfo, ServeRequest
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import TensorParallel, make_engine_mesh, spawn
from repro_torch.lora.adapter import (_target_in_dim, _target_out_dim,
                                      bank_layers)
from repro_torch.models import model as M
from repro_torch.serving import (EngineBackend, LoRAServeCluster, Request,
                                 ServingEngine)
from repro_torch.serving.backend import serve_follower

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
    one ``torch.Generator``, at each target's own widths (d_in, d_out:
    ``lora.adapter._target_in_dim`` / ``_target_out_dim``) and the bank's
    layers (``lora.adapter.bank_layers``: one for the hybrid family)."""
    g = torch.Generator(device=device).manual_seed(seed)
    L, d = bank_layers(cfg), cfg.d_model
    return {aid: {t: {"A": (torch.randn((L, _target_in_dim(cfg, t), r),
                                        generator=g, device=device)
                            / d ** 0.5).to(dtype),
                      "B": (torch.randn((L, r, _target_out_dim(cfg, t)),
                                        generator=g, device=device)
                            * (0.5 / r ** 0.5)).to(dtype)}
                  for t in cfg.lora.targets}
            for aid, r in ranks.items()}


def registered_weights(cfg, adapter_id: str, rank: int, *, dtype, device,
                       seed):
    """The weights of an adapter that was not among the seeded ones (one
    registered at run time, over HTTP): ``adapter_weights`` of that
    adapter alone, from a seed made of ``seed`` and the adapter's id, so
    an id gets the same weights in every run."""
    return adapter_weights(
        cfg, {adapter_id: rank}, dtype=dtype, device=device,
        seed=zlib.crc32(f"{seed}:{adapter_id}".encode()))[adapter_id]


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
        args.arch)
    dtype = getattr(torch, args.dtype)
    # the rank's slice only: each block is sliced as it is drawn
    params = M.init_params(cfg, args.seed, dtype=dtype, device=device,
                           tp=mesh)
    trace = build_trace(cfg, args.requests, args.prompt_lens, args.max_new,
                        args.seed)
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


# ---------------------------------------------------------------------------
# the cluster facade (--servers N)
# ---------------------------------------------------------------------------


def cluster_adapters(n: int):
    """``n`` adapters ``ad{i}-r{rank}``, ranks {8, ..., 128} in turn, of
    rank x 2 MB each (the JAX package's launcher's)."""
    return [AdapterInfo(f"ad{i}-r{RANKS[i % 5]}", RANKS[i % 5],
                        nbytes=RANKS[i % 5] * 2_000_000) for i in range(n)]


def build_cluster_trace(adapters, cfg, n_requests: int, prompt_lens,
                        max_new: int, duration: float, seed: int):
    """The JAX package's ``launch/serve.py:build_trace``: arrivals spread
    over ``duration`` seconds with drifting popularity (early traffic
    favors low-rank adapters, late traffic high-rank: the workload shift
    that makes the dynamic policy re-place). Prompt lengths take
    ``prompt_lens`` in turn; with one length the trace is the JAX
    package's, draw for draw."""
    rng = random.Random(seed)
    by_rank = sorted(adapters, key=lambda a: a.rank)
    trace = []
    for i in range(n_requests):
        progress = i / max(1, n_requests - 1)
        w = [(1.0 - progress) * (len(by_rank) - j) + progress * (j + 1)
             for j in range(len(by_rank))]
        a = rng.choices(by_rank, weights=w)[0]
        plen = prompt_lens[i % len(prompt_lens)]
        prompt = [rng.randrange(1, cfg.vocab_size) for _ in range(plen)]
        trace.append(ServeRequest(
            req_id=i, adapter_id=a.adapter_id, rank=a.rank,
            prompt_len=plen, output_len=max_new, prompt=prompt,
            arrival=i * duration / max(1, n_requests)))
    return trace


class SeededWeightsBackend(EngineBackend):
    """An ``EngineBackend`` whose engines serve the given nonzero adapter
    ``weights`` ({adapter: {target: {"A", "B"}}}, full width). A bank the
    engine builds has B = 0, so every delta would be 0; after each call
    that builds an engine or rebuilds its bank, the weights of every hosted
    adapter go in again (an adapter just read from a peer keeps the peer's
    bytes). ``bank_ms`` holds the milliseconds of each such call, build or
    rebuild and installs, ended by a device sync; ``bank_builds`` and
    ``bank_rebuilds`` count them. An adapter missing from ``weights`` (one
    registered at run time) gets ``registered_weights`` from the backend's
    seed, in the params' dtype."""

    def __init__(self, *args, weights, **kw):
        self.weights = dict(weights)
        self.bank_ms = []
        self.bank_builds = 0
        self.bank_rebuilds = 0
        # engine -> its bank_rebuilds when the weights last went in (weak:
        # a failed or retired engine's bank and cache must be freed)
        self._installed = weakref.WeakKeyDictionary()
        super().__init__(*args, **kw)

    def _reinstall(self, server_id, t0, remote=None):
        """Install the weights again if the engine of ``server_id`` was
        built or its bank rebuilt since they last went in; keep
        ``remote``'s rows when they were read from a peer."""
        eng = self.engines[server_id]
        if eng is None:
            return
        old = self._installed.get(eng)
        if old == eng.bank_rebuilds:
            return
        for aid, rank in eng.adapter_ranks.items():
            if aid != remote or aid not in self._remote[server_id]:
                eng.install_adapter(aid, rank, self.weights_of(aid, rank))
        self._installed[eng] = eng.bank_rebuilds
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.bank_ms.append((time.perf_counter() - t0) * 1e3)
        if old is None:
            self.bank_builds += 1
        else:
            self.bank_rebuilds += 1

    def weights_of(self, adapter_id, rank):
        """The seeded weights of ``adapter_id``, made on first use for an
        adapter registered at run time."""
        if adapter_id not in self.weights:
            self.weights[adapter_id] = registered_weights(
                self.cfg, adapter_id, rank, dtype=self.params.embed.dtype,
                device=self.device, seed=self.seed)
        return self.weights[adapter_id]

    def load_adapters(self, server_id, adapter_ranks):
        t0 = time.perf_counter()
        super().load_adapters(server_id, adapter_ranks)
        self._reinstall(server_id, t0)

    def load_adapter_remote(self, server_id, adapter_id, rank, peer_server):
        t0 = time.perf_counter()
        super().load_adapter_remote(server_id, adapter_id, rank, peer_server)
        self._reinstall(server_id, t0, remote=adapter_id)

    def evict_adapter(self, server_id, adapter_id):
        t0 = time.perf_counter()
        evicted = super().evict_adapter(server_id, adapter_id)
        self._reinstall(server_id, t0)
        return evicted


def make_cluster(cfg, params, adapters, weights, n_servers: int, *,
                 max_len: int, max_batch: int = 8, seed: int = 0,
                 bank_mode: str = "padded", decode_block: int = 1,
                 lora_kernel: str = "sgmv", policy: str = "loraserve",
                 rebalance_period: float = 1.5, access_mode: str = "migrate",
                 prefetch: bool = False, controller=None, fault_plan=None,
                 detector_window: float = 0.5, mesh_shape=None,
                 tracer=None, flight_recorder=None, page_pool_factory=None,
                 device="cuda"):
    """``LoRAServeCluster`` over a ``SeededWeightsBackend`` of ``n_servers``
    engines that share ``params``, set up as the JAX package's launcher
    sets up its cluster (``tracer``, ``flight_recorder``: the span layer,
    ``repro_torch.obs``; ``page_pool_factory``: a unified page pool for
    each engine). Building it places the adapters and builds the
    engines. Under ``mesh_shape`` it runs on rank 0; every other rank
    builds its ``SeededWeightsBackend`` with the same arguments and
    follows it (``backend.serve_follower``) until rank 0's
    ``cluster.backend.close()``."""
    backend = SeededWeightsBackend(
        cfg, params, n_servers, weights=weights, max_batch=max_batch,
        max_len=max_len, seed=seed, bank_mode=bank_mode,
        decode_block=decode_block, lora_kernel=lora_kernel,
        mesh_shape=mesh_shape, page_pool_factory=page_pool_factory,
        device=device)
    return LoRAServeCluster(
        backend, adapters, policy=policy, network=NetworkModel(),
        rebalance_period=rebalance_period, seed=seed,
        access_mode=access_mode, prefetch=prefetch, controller=controller,
        tracer=tracer, flight_recorder=flight_recorder,
        fault_plan=fault_plan, detector_window=detector_window,
        durable_ssd=fault_plan is not None)


def drive(cluster, trace, dt: float, max_polls: int = 100_000):
    """Serve ``trace`` on a virtual clock: each request is submitted at the
    first poll at or after its arrival, and ``poll(now)`` runs every ``dt``
    virtual seconds until the cluster is idle. Routing, rebalances, fault
    times and tokens then depend on ``now`` alone, not on the wall clock
    (which still stamps TTFT and TBT). Works on any ``LoRAServeCluster``.
    Returns the report."""
    trace = sorted(trace, key=lambda r: r.arrival)
    i = 0
    for k in range(max_polls):
        now = k * dt
        while i < len(trace) and trace[i].arrival <= now + 1e-12:
            cluster.submit(trace[i], now)
            i += 1
        cluster.poll(now)
        if i == len(trace) and cluster.idle():
            return cluster.report()
    raise RuntimeError(f"cluster not idle after {max_polls} polls")


def warm_up(cfg, params, weights, *, bank_mode, decode_block, device):
    """Build the kernels and run each once (one short request through a
    throwaway engine) so that no request of a timed run pays the nvcc
    build or a first launch."""
    aid = min(weights, key=lambda a: int(a.rsplit("-r", 1)[1]))
    serve(cfg, params, [(aid, [1, 2, 3, 4], 2)],
          weights={aid: weights[aid]}, bank_mode=bank_mode,
          decode_block=decode_block, max_batch=1, device=device)


def cluster_summary(cluster, report, trace) -> dict:
    """What a cluster run adds to its report: decode tokens/s over the run
    (tokens after each request's first, between the first first token and
    the last finish, wall clock), each server's mean TBT, and the bank
    builds and rebuilds with their milliseconds."""
    reqs = [r for r in trace
            if r.t_first_token is not None and r.t_finish is not None]
    toks = sum(len(r.output) - 1 for r in reqs)
    span = (max(r.t_finish for r in reqs)
            - min(r.t_first_token for r in reqs)) if reqs else 0.0
    tbt = {}
    for r in report.results:
        if r.finished and r.tbt:
            tbt.setdefault(r.server, []).append(r.tbt)
    be = cluster.backend
    return {"decode_tok_s": toks / span if span > 0 else float("nan"),
            "server_mean_tbt": {s: sum(v) / len(v)
                                for s, v in sorted(tbt.items())},
            "bank_builds": be.bank_builds,
            "bank_rebuilds": be.bank_rebuilds,
            "bank_ms": list(be.bank_ms)}


def print_cost_drift(report) -> None:
    """The ``costmodel[phase]`` lines: measured iteration spans against
    the cost model's prediction for the same batch shapes. The model is
    the paper's A100 fleet's (``cluster/costmodel.py``), so on the card
    the bias is H100 against A100, not an error of a model of the card."""
    for phase, d in sorted(report.cost_drift.items()):
        print(f"costmodel[{phase}]: n={d['count']} "
              f"modeled={d['modeled_s']:.3f}s "
              f"measured={d['measured_s']:.3f}s "
              f"bias={d['bias']:+.1%} "
              f"mare={d['mean_abs_rel_err']:.1%} "
              f"(the paper's A100 model vs measured spans)")


def _serve_cluster(rank: int, dp: int, tp: int, args) -> None:
    """The ``--servers N`` and ``--serve`` paths: the JAX package's
    launcher on the port, as rank ``rank`` of a (dp, tp) mesh: rank 0
    runs the facade and prints the report, the others follow it."""
    device = resolve_device(args.device)
    meshed = dp * tp > 1
    if meshed and device.type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
        device = torch.device("cuda", torch.cuda.current_device())
    cfg = (get_config if args.config == "full" else get_smoke_config)(
        args.arch)
    dtype = getattr(torch, args.dtype)
    # the rank's slice only (its tp rank's; the dp replicas hold the same)
    params = M.init_params(cfg, args.seed, dtype=dtype, device=device,
                           tp=TensorParallel(None, rank % tp, tp))
    adapters = cluster_adapters(args.adapters)
    weights = adapter_weights(cfg, {a.adapter_id: a.rank for a in adapters},
                              dtype=dtype, device=device, seed=args.seed)
    controller = None
    if args.controller:
        from repro_torch.controlplane import (ClusterController,
                                              ControllerConfig, SLOSpec)
        controller = ClusterController(
            SLOSpec(ttft=args.slo_ttft, target=args.slo_target,
                    window=max(4 * args.tick_period, 2.0)),
            ControllerConfig(tick_period=args.tick_period,
                             min_servers=args.min_servers,
                             max_servers=args.max_servers))
    fault_plan = None
    if args.fault_plan:
        from repro_torch.faults import FaultPlan
        fault_plan = FaultPlan.load(args.fault_plan)
    elif args.chaos is not None:
        from repro_torch.faults import FaultPlan
        fault_plan = FaultPlan.random_plan(
            args.chaos, horizon=args.duration, n_servers=args.servers)
    tracer = recorder = None
    if args.trace_out or args.flight_recorder:
        from repro_torch.obs import FlightRecorder, Tracer, WallClock
        tracer = Tracer(clock=WallClock())
        if args.flight_recorder:
            recorder = FlightRecorder(out_dir=args.flight_recorder)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
        if meshed:              # a rank's slice serves no engine alone
            from repro_torch.kernels import build
            build.load_library()
        else:
            warm_up(cfg, params, weights, bank_mode=args.bank_mode,
                    decode_block=args.decode_block, device=device)
    engines = dict(max_len=max(args.prompt_lens) + args.max_new + 8,
                   max_batch=args.max_batch, seed=args.seed,
                   bank_mode=args.bank_mode, decode_block=args.decode_block,
                   lora_kernel=args.lora_kernel,
                   mesh_shape=(dp, tp) if meshed else None, device=device)
    if rank != 0:
        serve_follower(SeededWeightsBackend(cfg, params, args.servers,
                                            weights=weights, **engines))
        return
    cluster = make_cluster(
        cfg, params, adapters, weights, args.servers, policy=args.policy,
        rebalance_period=args.rebalance_period,
        access_mode=args.access_mode, prefetch=args.prefetch,
        controller=controller, fault_plan=fault_plan,
        detector_window=args.detector_window, tracer=tracer,
        flight_recorder=recorder, **engines)

    def spans(report):
        if args.trace_out:
            from repro_torch.obs import write_jsonl, write_perfetto
            writer = (write_jsonl if args.trace_out.endswith(".jsonl")
                      else write_perfetto)
            n = writer(tracer, args.trace_out)
            print(f"trace: {n} spans -> {args.trace_out}")
        if tracer is not None:
            print_cost_drift(report)
        if recorder is not None:
            print(f"flight_recorder: dumps={recorder.n_dumps} "
                  f"-> {args.flight_recorder}")

    if args.serve:
        from .server import run_gateway
        host, _, port = args.serve.rpartition(":")
        report = run_gateway(cluster, host or "127.0.0.1", int(port),
                             rate=args.rate, max_inflight=args.max_inflight,
                             announce=lambda s: print(s, flush=True))
        cluster.backend.close()
        print(f"served={report.completed()} "
              f"timed_out={report.timed_out} "
              f"registered={report.registered} "
              f"unregistered={report.unregistered}")
        spans(report)
        print("gateway drained OK", flush=True)
        return
    trace = build_cluster_trace(adapters, cfg, args.requests,
                                args.prompt_lens, args.max_new,
                                args.duration, args.seed)
    report = (profiled(lambda: cluster.run(trace), device) if args.profile
              else cluster.run(trace))
    cluster.backend.close()
    extra = cluster_summary(cluster, report, trace)

    where = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    print(f"model={cfg.name} layers={cfg.n_layers} dtype={args.dtype} "
          f"device={where} servers={args.servers} "
          f"lora_kernel={args.lora_kernel} "
          f"decode_block={args.decode_block}")
    for sid, mem in enumerate(report.memory_profile):
        tbt = extra["server_mean_tbt"].get(sid, float("nan"))
        print(f"server {sid}: requests={report.per_server_counts[sid]} "
              f"bank_adapters={mem['n_adapters']} "
              f"bank_max_rank={mem['max_rank']} "
              f"bank_bytes={mem['adapter_bytes']} "
              f"mean_tbt={tbt * 1e3:.1f}ms")
    s = report.summary
    print(f"bank_mode={report.bank_mode} mesh={report.mesh_shape}")
    print(f"policy={args.policy} finished={report.completed()}"
          f"/{len(trace)} p50_ttft={s['p50_ttft']:.3f}s "
          f"p95_ttft={s['p95_ttft']:.3f}s "
          f"mean_tbt={s['mean_tbt'] * 1e3:.1f}ms "
          f"decode_tok/s={extra['decode_tok_s']:.1f} "
          f"fetch_latency(mean)={s['mean_fetch_latency'] * 1e3:.1f}ms")
    print(f"rebalances={report.rebalances} "
          f"placement_changed={report.placement_changed()} "
          f"pool_fetches={report.fetches} "
          f"max_adapters/server={report.max_adapters_per_server}")
    print(f"access_mode={report.access_mode} "
          f"remote_reads={report.remote_reads} "
          f"prefetches={report.prefetches} "
          f"coalesced_fetches={report.coalesced_fetches}")
    ms = extra["bank_ms"]
    print(f"banks: builds={extra['bank_builds']} "
          f"rebuilds={extra['bank_rebuilds']} total_ms={sum(ms):.1f} "
          f"max_ms={max(ms, default=0.0):.1f}"
          + (f" peak_mem_gb={torch.cuda.max_memory_allocated(device) / 1e9:.2f}"
             if device.type == "cuda" else ""))
    if fault_plan is not None:
        print(f"chaos: failures={report.server_failures} "
              f"recoveries={report.recoveries} "
              f"redispatched={report.redispatched} "
              f"fetch_retries={report.fetch_retries} "
              f"fetch_timeouts={report.fetch_timeouts} "
              f"breaker_opens={report.breaker_opens}")
    if args.controller:
        print(f"controller: "
              f"slo_attainment={report.slo_attainment(args.slo_ttft):.3f} "
              f"scale_ups={report.scale_ups} drains={report.drains} "
              f"retires={report.retires} "
              f"oob_rebalances={report.controller_rebalances} "
              f"final_servers={report.final_servers} "
              f"gpu_seconds={report.gpu_seconds:.1f} "
              f"drift_events={len(report.drift_events)}")
    spans(report)
    print("cluster drained OK", flush=True)


def parse_args(argv=None):
    """The launcher's arguments; ``prompt_lens`` comes back as a list of
    ints, from ``--prompt-lens`` or the JAX launcher's ``--prompt-len``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama-7b-paper", choices=ARCH_IDS)
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
    lens = ap.add_mutually_exclusive_group()
    lens.add_argument("--prompt-lens", default="64,128",
                      help="comma-separated prompt lengths, used in turn")
    lens.add_argument("--prompt-len", type=int, default=None,
                      help="one prompt length: the trace of --prompt-lens N "
                           "(the JAX launcher's flag)")
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
                    help="DP,TP: a mesh of DP x TP ranks, TP "
                         "tensor-parallel ranks to a data-parallel replica")
    ap.add_argument("--backend", choices=["nccl", "gloo"],
                    help="torch.distributed backend of the ranks (default: "
                         "nccl on cuda, gloo on cpu)")
    cl = ap.add_argument_group(
        "cluster facade", "--servers N serves through LoRAServeCluster "
        "over N engines (the JAX package's launcher); --requests, "
        "--prompt-lens, --max-new, --bank-mode, --decode-block, "
        "--max-batch, --lora-kernel and --seed apply there too")
    cl.add_argument("--servers", type=int, default=None)
    cl.add_argument("--adapters", type=int, default=8)
    cl.add_argument("--policy", default="loraserve",
                    choices=sorted(POLICIES))
    cl.add_argument("--access-mode", default="migrate",
                    choices=["migrate", "remote-read"],
                    help="on a placement miss: block on the adapter fetch "
                         "(migrate) or serve at once, reading the weights "
                         "from a peer's bank while the local copy warms "
                         "(remote-read)")
    cl.add_argument("--prefetch", action="store_true",
                    help="warm newly placed adapters at each rebalance")
    cl.add_argument("--controller", action="store_true",
                    help="run the SLO-driven control plane: drift "
                         "detection, triggered rebalances, scale-up/drain "
                         "between --min-servers and --max-servers")
    cl.add_argument("--slo-ttft", type=float, default=5.0,
                    help="TTFT target (seconds) the controller defends")
    cl.add_argument("--slo-target", type=float, default=0.95,
                    help="required fraction of requests inside the SLO")
    cl.add_argument("--min-servers", type=int, default=1)
    cl.add_argument("--max-servers", type=int, default=4)
    cl.add_argument("--tick-period", type=float, default=1.0,
                    help="controller tick (seconds)")
    cl.add_argument("--chaos", type=int, default=None, metavar="SEED",
                    help="inject a seeded random fault storm over the run")
    cl.add_argument("--fault-plan", default=None, metavar="PATH",
                    help="replay a JSON fault schedule "
                         "(repro_torch.faults.FaultPlan)")
    cl.add_argument("--detector-window", type=float, default=0.5,
                    help="heartbeat silence (seconds) before a server is "
                         "confirmed dead and recovery runs")
    cl.add_argument("--duration", type=float, default=6.0,
                    help="seconds the trace's arrivals span")
    cl.add_argument("--rebalance-period", type=float, default=1.5)
    cl.add_argument("--serve", default=None, metavar="HOST:PORT",
                    help="serve the cluster over the streaming HTTP gateway "
                         "until SIGTERM instead of replaying a trace "
                         "(2 servers unless --servers is given)")
    cl.add_argument("--rate", type=float, default=None,
                    help="per-tenant admission rate (requests/s) with "
                         "--serve; unset = unlimited")
    cl.add_argument("--max-inflight", type=int, default=None,
                    help="per-tenant concurrent-request cap with --serve")
    cl.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write the run's spans: .jsonl one span a line, "
                         "else a Perfetto JSON document")
    cl.add_argument("--flight-recorder", default=None, metavar="DIR",
                    help="dump the recent spans (and the controller's "
                         "inputs) to DIR on SLO violations and scale "
                         "events")
    args = ap.parse_args(argv)
    args.prompt_lens = [args.prompt_len] if args.prompt_len is not None \
        else [int(v) for v in args.prompt_lens.split(",")]
    args.dp, args.tp = (int(v) for v in args.mesh.split(","))
    if args.dp < 1 or args.tp < 1:
        raise ValueError(f"--mesh {args.mesh}: dp and tp must be positive")
    return args


def main(argv=None):
    args = parse_args(argv)
    resolve_device(args.device)          # no card: refuse before a spawn
    if args.serve and args.servers is None:
        args.servers = 2
    run = _serve_rank if args.servers is None else _serve_cluster
    dp, tp = args.dp, args.tp
    if dp * tp == 1:
        run(0, dp, tp, args)
        return
    backend = args.backend or ("nccl" if args.device == "cuda" else "gloo")
    with tempfile.TemporaryDirectory() as tmp:
        ranks = spawn(run, dp * tp, backend=backend,
                      init_file=Path(tmp) / "init", args=(dp, tp, args),
                      join=False)
        # the gateway runs on rank 0: SIGTERM and SIGINT drain it there
        forward = (lambda sig, _: os.kill(ranks.processes[0].pid, sig))
        old = {sig: signal.signal(sig, forward)
               for sig in (signal.SIGTERM, signal.SIGINT)} \
            if args.serve else {}
        try:
            while not ranks.join():
                pass
        finally:
            for sig, handler in old.items():
                signal.signal(sig, handler)


if __name__ == "__main__":
    main()
