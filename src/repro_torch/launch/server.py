"""Gateway launcher of the PyTorch port: the streaming HTTP serving
surface over the port's engines.

  PYTHONPATH=src python -m repro_torch.launch.server --port 8080
  PYTHONPATH=src python -m repro_torch.launch.server --device cpu \\
      --config smoke --port 0

Builds a ``LoRAServeCluster``, wraps it in ``ServeGateway`` and serves
until SIGTERM/SIGINT, which triggers the graceful drain (stop admitting,
finish in-flight, retire servers) before the final report. ``--backend
engine`` (the default) serves ``--arch`` (``llama-7b-paper`` by default,
as in the JAX launcher) on the port's torch engines, on the card unless ``--device cpu``: ``--config full`` (the
default) at full width, bf16 weights from ``--seed``, the launcher's
adapters with nonzero seeded weights (an adapter registered over HTTP
gets its own, from the seed and its id), the kernels built and warmed
before the listener opens. ``--backend sim`` serves the discrete-event
cost model (the paper's A100 fleet) on the wall clock instead; it runs
on the host.

The JAX package's launcher defaults to ``--backend sim``; this one
defaults to the card. ``launch/serve.py --serve HOST:PORT`` delegates to
``run_gateway`` with its own cluster configuration.
"""
from __future__ import annotations

import argparse
import asyncio
from typing import Optional

from repro_torch.cluster import NetworkModel
from repro_torch.configs import ARCH_IDS
from repro_torch.core import POLICIES
from repro_torch.launch.serve import cluster_adapters
from repro_torch.serving import LoRAServeCluster, SimBackend


def build_sim_cluster(args) -> LoRAServeCluster:
    adapters = cluster_adapters(args.adapters)
    backend = SimBackend(
        args.servers,
        adapter_nbytes={a.adapter_id: a.nbytes for a in adapters})
    return LoRAServeCluster(
        backend, adapters, policy=args.policy,
        network=NetworkModel(args.servers),
        rebalance_period=args.rebalance_period, seed=args.seed)


def build_engine_cluster(args) -> LoRAServeCluster:
    """The launcher's adapters over ``args.servers`` engines that share one
    copy of seeded ``args.arch`` weights (``launch.serve.
    make_cluster``), kernels warmed on the card first."""
    import torch

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.device import resolve_device
    from repro_torch.launch.serve import (adapter_weights, make_cluster,
                                          warm_up)
    from repro_torch.models import model as M

    device = resolve_device(args.device)
    cfg = (get_config if args.config == "full" else get_smoke_config)(
        args.arch)
    dtype = getattr(torch, args.dtype)
    params = M.init_params(cfg, args.seed, dtype=dtype, device=device)
    adapters = cluster_adapters(args.adapters)
    weights = adapter_weights(cfg, {a.adapter_id: a.rank for a in adapters},
                              dtype=dtype, device=device, seed=args.seed)
    if device.type == "cuda":
        warm_up(cfg, params, weights, bank_mode=args.bank_mode,
                decode_block=args.decode_block, device=device)
    return make_cluster(
        cfg, params, adapters, weights, args.servers, max_len=args.max_len,
        max_batch=4, seed=args.seed, bank_mode=args.bank_mode,
        decode_block=args.decode_block, policy=args.policy,
        rebalance_period=args.rebalance_period, device=device)


def run_gateway(cluster: LoRAServeCluster, host: str, port: int, *,
                rate: Optional[float] = None,
                burst: Optional[float] = None,
                max_inflight: Optional[int] = None,
                announce=print):
    """Serve ``cluster`` on ``host:port`` until a shutdown signal lands,
    then drain gracefully and return the final ``ClusterReport``."""
    from repro_torch.server import AdmissionController, ServeGateway

    admission = AdmissionController(rate=rate, burst=burst,
                                    max_inflight=max_inflight)
    gw = ServeGateway(cluster, host, port, admission=admission)

    async def amain():
        await gw.start()
        announce(f"listening on {gw.host}:{gw.port}")
        await gw.serve_until_stopped()

    asyncio.run(amain())
    return gw.final_report


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080,
                    help="0 picks an ephemeral port (printed at startup)")
    ap.add_argument("--backend", default="engine",
                    choices=["sim", "engine"],
                    help="execution substrate: the port's torch engines "
                         "(engine) or the calibrated discrete-event cost "
                         "model (sim, on the host)")
    ap.add_argument("--arch", default="llama-7b-paper", choices=ARCH_IDS,
                    help="the served model (engine)")
    ap.add_argument("--config", default="full", choices=["full", "smoke"],
                    help="--arch at full width or reduced (engine)")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["bfloat16", "float32"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--bank-mode", default="padded",
                    choices=["padded", "bucketed"])
    ap.add_argument("--decode-block", type=int, default=1,
                    help="decode tokens per host sync")
    ap.add_argument("--servers", type=int, default=2)
    ap.add_argument("--adapters", type=int, default=8)
    ap.add_argument("--policy", default="loraserve",
                    choices=sorted(POLICIES))
    ap.add_argument("--rebalance-period", type=float, default=5.0)
    ap.add_argument("--max-len", type=int, default=64,
                    help="engine sequence budget (prompt + output)")
    ap.add_argument("--rate", type=float, default=None,
                    help="per-tenant admission rate (requests/s); "
                         "unset = unlimited")
    ap.add_argument("--burst", type=float, default=None,
                    help="per-tenant token-bucket burst (default: rate)")
    ap.add_argument("--max-inflight", type=int, default=None,
                    help="per-tenant concurrent-request cap")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cluster = (build_sim_cluster(args) if args.backend == "sim"
               else build_engine_cluster(args))
    report = run_gateway(cluster, args.host, args.port, rate=args.rate,
                         burst=args.burst,
                         max_inflight=args.max_inflight,
                         announce=lambda s: print(s, flush=True))
    s = report.summary
    print(f"served={report.completed()} timed_out={report.timed_out} "
          f"registered={report.registered} "
          f"unregistered={report.unregistered} "
          f"rebalances={report.rebalances}")
    if report.completed():
        print(f"p50_ttft={report.p50_ttft():.3f}s "
              f"p95_ttft={report.p95_ttft():.3f}s "
              f"mean_tbt={(s['mean_tbt'] or 0) * 1e3:.1f}ms")
    print("gateway drained OK")


if __name__ == "__main__":
    main()
