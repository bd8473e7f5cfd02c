"""End-to-end example: the same ``LoRAServeCluster`` facade serving a
heavy-tailed LoRA trace under all four policies — first on the simulated
backend (the paper's headline experiment, Fig 17, at laptop scale), then
on a mini cluster of 2 placement-aware engines of the port. One API, two
substrates: the port's counterpart of the JAX package's
``examples/serve_cluster.py``, with its trace, adapters, policies and
lines. The engines run on the card by default; ``--device cpu`` runs
the kernels' plain versions.

  PYTHONPATH=src python -m repro_torch.examples.serve_cluster [--device cpu]
"""
import argparse
import copy
import random

from repro_torch.cluster import NetworkModel
from repro_torch.configs import get_smoke_config
from repro_torch.core import AdapterInfo, ServeRequest
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.serving import EngineBackend, LoRAServeCluster, SimBackend
from repro_torch.traces import make_adapters, production_trace


def simulated_cluster():
    """Returns {policy: its ClusterReport}."""
    print("=== simulated 4-server cluster, production trace, 100 adapters")
    adapters = make_adapters(100, seed=1)
    trace = production_trace(100, rps=20, duration=150, seed=2)
    nbytes = {a.adapter_id: a.nbytes for a in adapters}
    out = {}
    for pol in ["loraserve", "toppings", "slora-random",
                "slora-contiguous"]:
        backend = SimBackend(4, timeout=60, adapter_nbytes=nbytes)
        cluster = LoRAServeCluster(backend, adapters, policy=pol,
                                   network=NetworkModel(), warmup=40,
                                   seed=3)
        res = cluster.run(copy.deepcopy(trace))
        out[pol] = res
        print(f"{pol:18s} p95_ttft={res.p95_ttft():8.3f}s "
              f"tbt={res.mean_tbt() * 1e3:6.1f}ms "
              f"max_adapters/server={res.max_adapters_per_server:3d} "
              f"rebalances={res.rebalances} timeouts={res.timed_out}")
    return out


def real_mini_cluster(device="cuda"):
    """Returns (the ClusterReport, the trace, the invariant's verdict)."""
    dev = resolve_device(device)
    print(f"=== mini cluster of the port's engines (2, on {dev}) behind "
          f"the same facade")
    rng = random.Random(0)
    cfg = get_smoke_config("llama-7b-paper")
    params = M.init_params(cfg, 0, device=dev)
    adapters = [AdapterInfo(f"ad{i}-r{r}", r, nbytes=r * 2_000_000)
                for i, r in enumerate([8, 8, 32, 64, 128, 128])]
    backend = EngineBackend(cfg, params, 2, max_batch=4, max_len=40,
                            device=dev)
    cluster = LoRAServeCluster(backend, adapters, policy="loraserve",
                               network=NetworkModel(),
                               rebalance_period=2.0)
    trace = []
    for i in range(10):
        a = rng.choice(adapters)
        prompt = [rng.randrange(1, cfg.vocab_size) for _ in range(10)]
        trace.append(ServeRequest(req_id=i, adapter_id=a.adapter_id,
                                  rank=a.rank, prompt_len=10,
                                  output_len=6, prompt=prompt,
                                  arrival=i * 0.3))
    res = cluster.run(trace)
    for sid in range(2):
        mem = res.memory_profile[sid]
        print(f"server {sid}: requests={res.per_server_counts[sid]} "
              f"bank_max_rank={mem['max_rank']}")
    ok = cluster.orch.pool.check_invariant()
    print(f"finished={res.completed()}/10 "
          f"p95_ttft={res.summary['p95_ttft']:.2f}s "
          f"pool: fetches={res.fetches} "
          f"max_adapters/server={res.max_adapters_per_server} "
          f"invariant={'OK' if ok else 'BROKEN'}")
    return res, trace, ok


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    return simulated_cluster(), real_mini_cluster(args.device)


if __name__ == "__main__":
    main()
