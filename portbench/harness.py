"""One run of one cell: set-up, the measured window, the drain, the
readings and the check of what the window served.

The entry the window drives is the port's cluster facade,
``LoRAServeCluster`` with one server over the launcher's
``SeededWeightsBackend`` (``repro_torch.launch.serve.make_cluster``),
through ``submit`` and ``poll`` as the launcher and the gateway call it.
Every cluster time below is on the facade's clock (``cluster.clock()``,
the backend's wall clock), on which the engine also stamps each request's
``prefill_start``, ``t_first_token`` and ``t_finish``.

The traffic is a closed loop: ``max_batch`` clients, each sending its
next job as soon as its last one has finished, opened in the loop's
steady state.

A cell is found by name: ``BENCHMARK.json`` names its configuration and
traffic, whose files are ``portbench/configs/<config>.json`` and
``portbench/traffic/<traffic>.json``; ``portbench/cells/<workload>.json``
holds the engine's settings and the check's limit; each metric is read by
``portbench/metrics/<name>.py``.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

from . import check, devtrace, traffic, weights

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Cell:
    workload: str
    config_name: str
    config: dict
    mix: dict
    engine: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def _metrics_for(entries, workload):
    return [m for m in entries
            if "workloads" not in m or workload in m["workloads"]]


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    """The cell ``workload`` of ``BENCHMARK.json``: its configuration,
    traffic and engine settings from their files, by name."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    (w,) = [w for w in bench["workloads"] if w["name"] == workload]

    def data(folder, name):
        return json.loads((HERE / folder / f"{name}.json").read_text())
    mix = data("traffic", w["traffic"])
    if mix["loop"] != "closed":
        raise ValueError(f"{w['traffic']}: the harness drives closed loops")
    return Cell(workload=workload, config_name=w["config"],
                config=data("configs", w["config"]), mix=mix,
                engine=data("cells", workload),
                end_to_end=_metrics_for(bench["end_to_end"], workload),
                per_layer=_metrics_for(bench["per_layer"], workload))


def forbidden_modules() -> List[str]:
    """Modules loaded in this process whose top-level name is one the
    benchmark may not load (compared whole: ``repro_torch`` is not
    ``repro``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def process_age_s() -> float:
    """Seconds since this process started, from the kernel's record of
    its start (``/proc/self/stat``, in clock ticks since boot)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    return time.clock_gettime(time.CLOCK_BOOTTIME) - started


def read_metric(name: str, ctx) -> Optional[float]:
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name}", HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


@dataclasses.dataclass
class Record:
    """What the readers see of one request."""
    req: object                       # the ServeRequest
    rank: int
    out_open: int = 0                 # tokens it had when the window opened
    out_close: int = 0                # ... when it closed (a traced run:
                                      # when the trace started)


@dataclasses.dataclass
class Context:
    """What a metric's reader reads (``portbench/metrics/*.py``)."""
    cell: Cell
    ref: object                       # the architecture's reference module
    kind: str                         # the card's name
    t_open: float
    t_close: float
    records: List[Record]
    spans: list = dataclasses.field(default_factory=list)
    iters: list = dataclasses.field(default_factory=list)
    trace: Optional[devtrace.Trace] = None
    trace_span: tuple = (0.0, 0.0)    # cluster times the trace covers
    setup_s: float = 0.0
    peak_window_bytes: int = 0

    @property
    def window_s(self) -> float:
        return self.t_close - self.t_open


class IterationLog:
    """A tracer listener that keeps, for each engine iteration (a prefill
    group or a decode block), the tokens each adapter's rows needed in
    each step: what the LoRA metric's bound is counted from."""

    def __init__(self, cluster):
        self.cluster = cluster
        self.iters = []

    def __call__(self, span):
        if span.name not in ("prefill", "decode") or span.cat != "iteration":
            return
        eng = self.cluster.backend.engines[0]
        live = [r for r in eng.slots if r is not None]
        if span.name == "prefill":
            grp = [r for r in live if r.prefill_start == span.start]
            steps = [{r.adapter_id: len(r.prompt) for r in grp}]
        else:
            k = span.attrs["steps"]
            left = {id(r): max(1, min(r.max_new_tokens - len(r.output),
                                      eng.max_len - len(r.prompt)
                                      - len(r.output))) for r in live}
            steps = []
            for j in range(k):
                toks: Dict[str, int] = {}
                for r in live:
                    if left[id(r)] > j:
                        toks[r.adapter_id] = toks.get(r.adapter_id, 0) + 1
                steps.append(toks)
        self.iters.append((span.name, span.start, span.end, steps))


def _cluster(cell: Cell, w, aw, ads, seed, device, tracer):
    from repro_torch.core import AdapterInfo
    from repro_torch.launch.serve import make_cluster
    arch = importlib.import_module(
        f"portbench.arch.{cell.config['model_type']}")
    cfg = arch.port_config(cell.config_name, cell.config)
    params = arch.port_params(cfg, w)
    e = cell.engine
    infos = [AdapterInfo(aid, rank, nbytes=rank * 2_000_000)
             for aid, rank, _ in ads]
    # the bank's own seed goes 32 bits up into an int64
    # (lora/adapter.py:adapter_key), so the program gets the seed's low 31
    # bits; the bank's seeded rows are overwritten by the benchmark's
    return make_cluster(cfg, params, infos, aw, 1, max_len=e["max_len"],
                        max_batch=e["max_batch"], seed=seed & 0x7FFFFFFF,
                        bank_mode=e["bank_mode"],
                        decode_block=e["decode_block"],
                        lora_kernel=e["lora_kernel"], tracer=tracer,
                        device=device)


class Driver:
    """Submits the traffic to the cluster and polls it, as a closed loop
    of clients would: each sends its next job as soon as its last one has
    finished."""

    def __init__(self, cluster, jobs):
        self.cluster = cluster
        self.jobs = list(jobs)
        self.next = 0
        self.records: List[Record] = []
        self._ids = 0

    def submit(self, job) -> Record:
        from repro_torch.serving import Request
        now = self.cluster.clock()
        req = Request(self._ids, job.adapter_id, job.prompt, job.output_len,
                      arrival=now, rank=job.rank)
        self._ids += 1
        self.cluster.submit(req, now)
        rec = Record(req, job.rank)
        self.records.append(rec)
        return rec

    def poll(self):
        """Poll once; each finished job's client sends its next."""
        cl = self.cluster
        events = cl.poll(cl.clock())
        for ev in events:
            if ev.kind == "finish" and self.next < len(self.jobs):
                self.submit(self.jobs[self.next])
                self.next += 1
        return events


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             control: bool = False) -> dict:
    """One run. Returns the result's parts: ``metrics`` (name -> value),
    ``attempted``, ``failed``, ``compared`` (the check's numbers),
    ``memory_peak_bytes``, and with ``trace`` the trace's ``busy_s``,
    ``window_s`` and ``breakdown``."""
    from repro_torch.obs import Tracer
    device = torch.device(device)
    say(f"started {process_age_s():.2f}s after the process")
    c, mix = cell.config, cell.mix
    ref = importlib.import_module(f"portbench.arch.{c['model_type']}_ref")
    dtype = getattr(torch, c["torch_dtype"])       # the type served in
    w = weights.base_weights(ref.weight_specs(c), seed, device, dtype)
    ads = traffic.adapters(mix["adapters"])
    aw = weights.adapter_weights(ads, ref.lora_dims(c),
                                 c["num_hidden_layers"], seed, device, dtype)
    say(f"weights made, {process_age_s():.2f}s")
    tracer = Tracer() if trace else None
    cluster = _cluster(cell, w, aw, ads, seed, device, tracer)
    say(f"cluster built, {process_age_s():.2f}s")
    log = None
    if trace:
        log = IterationLog(cluster)
        tracer.add_listener(log)
    V = c["vocab_size"]
    drv = Driver(cluster, traffic.make_jobs(mix, mix["jobs"], V, seed))
    _warm(drv, cell, V, seed)
    if trace:       # the profiler's first start is slow: pay it here
        devtrace.finish(devtrace.start(), 0.0)
    sync = torch.cuda.synchronize if device.type == "cuda" else (
        lambda: None)
    sync()
    setup_peak = 0
    if device.type == "cuda":
        setup_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)

    # -- the window --------------------------------------------------------
    # what set-up made lives to the end: the collector leaves it be
    gc.collect()
    gc.freeze()
    t_open = cluster.clock()
    setup_s = process_age_s()
    host0 = host_sample(device)
    say(f"warm, window opens at {setup_s:.2f}s")
    for r in drv.records:
        r.out_open = len(r.req.output)
    # the trace covers the window's last seconds and stops after its close
    trace_from = t_open + seconds - min(8.0, 0.3 * seconds)
    prof = None
    while True:
        drv.poll()
        now = cluster.clock()
        if trace and prof is None and now >= trace_from:
            t_trace0 = cluster.clock()
            for r in drv.records:
                r.out_close = len(r.req.output)
            prof = devtrace.start()
        if now >= t_open + seconds:
            break
    t_close = cluster.clock()
    host1 = host_sample(device)
    if not trace:
        for r in drv.records:
            r.out_close = len(r.req.output)
    peak_window = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)
    if prof is not None:
        t_prof = (t_trace0, t_close)
        tr = devtrace.finish(prof, t_close - t_trace0)

    sync()
    peak = max(setup_peak, torch.cuda.max_memory_allocated(device)
               if device.type == "cuda" else 0)
    say(f"window {t_close - t_open:.2f}s")
    say("host over the window: " + ", ".join(
        f"{k} {host1[k] - host0[k]:.3f}" for k in host0))

    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    ctx = Context(cell, ref, kind, t_open, t_close, drv.records,
                  setup_s=setup_s, peak_window_bytes=peak_window)
    # every request live in the window was attempted; none has a due time
    # to miss, and one that has not finished by the close is in flight
    attempted = sum(1 for r in ctx.records if r.req.t_finish is None
                    or r.req.t_finish >= t_open)
    finished = [r for r in ctx.records if r.req.t_finish is not None
                and r.req.t_finish <= t_close]
    if trace:
        # the profiler slows the host, so what the spans and the requests
        # show is read from the window before the traced slice, and the
        # trace from the slice
        ctx = dataclasses.replace(ctx, t_close=t_prof[0],
                                  spans=list(tracer.spans), iters=log.iters,
                                  trace=tr, trace_span=t_prof)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = read_metric(m["name"], ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    # -- the check: the program's state is freed first (a closed loop's
    # requests are still in flight: the cluster is dropped, not drained)
    del cluster, drv, log, tracer
    gc.unfreeze()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.monotonic()
    compared = check.compare(cell, ref, w, aw, finished, seed, control)
    say(f"checked in {time.monotonic() - t:.2f}s")
    out = {"metrics": metrics, "attempted": attempted, "failed": 0,
           "compared": compared, "memory_peak_bytes": peak, "kind": kind}
    if trace:
        out.update(busy_s=tr.busy_s, window_s=tr.window_s,
                   breakdown=tr.breakdown())
    return out


def say(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def host_sample(device) -> dict:
    """Counters that show what else held this process back while the
    host drives the card, printed for the window (never a metric): the
    process's CPU seconds, the machine's steal time summed over its cores
    (``/proc/stat``), and the caching allocator's retries (each a flush
    of its cache and a sync)."""
    t = os.times()
    out = {"cpu_s": t.user + t.system}
    try:
        with open("/proc/stat") as f:
            out["steal_s"] = int(f.readline().split()[8]) / os.sysconf(
                "SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        pass
    if device.type == "cuda":
        out["alloc_retries"] = torch.cuda.memory_stats(device).get(
            "num_alloc_retries", 0)
    return out


def _warm(drv: Driver, cell: Cell, V: int, seed: int) -> None:
    """Set-up the traffic needs, which warms the shapes it uses: the
    clients start in the loop's steady state (``traffic.steady_start``),
    their prompts prefilled and their first decode blocks run before the
    window opens."""
    first = traffic.steady_start(cell.mix, cell.engine["max_batch"], V, seed)
    recs = [drv.submit(j) for j in first]
    drv.poll()
    while any(r.req.t_first_token is None for r in recs):
        drv.poll()
