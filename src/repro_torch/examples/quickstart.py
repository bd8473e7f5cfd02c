"""Quickstart: serve a small multi-LoRA model on one engine — the port's
counterpart of the JAX package's ``examples/quickstart.py``, with its
config, adapters, requests and lines.

Loads the reduced Llama-7B-family config, creates a 4-adapter bank with
heterogeneous ranks (8..128), submits a handful of requests through the
continuous-batching engine (LoRA on the SGMV kernels, prefill attention
on B5), and prints TTFT/TBT metrics — the minimal single-server slice of
the paper's stack. The default device is the card; ``--device cpu`` runs
the kernels' plain versions.

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
import argparse
import time

from repro_torch.configs import get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.serving import Request, ServingEngine


def main(argv=None):
    """Serves the five requests; returns (the engine's summary, each
    request's tokens by id)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_smoke_config("llama-7b-paper")
    params = M.init_params(cfg, 0, device=dev)
    adapters = {"support-bot": 8, "code-assist": 32,
                "summarizer": 64, "legal-redline": 128}
    engine = ServingEngine(cfg, params, adapters, max_batch=4, max_len=64,
                           device=dev)
    print(f"engine up: {len(adapters)} adapters, bank max rank "
          f"{engine.max_rank} (every co-batched request pays it)")

    now = time.monotonic()
    prompts = [
        ("support-bot", [12, 45, 88, 21, 9, 4]),
        ("legal-redline", [7, 3, 99, 150, 31, 18, 42]),
        ("code-assist", [5, 5, 23, 77]),
        ("summarizer", [61, 2, 19, 240, 11]),
        ("support-bot", [90, 14, 3]),
    ]
    reqs = [Request(i, aid, prompt, max_new_tokens=8, arrival=now)
            for i, (aid, prompt) in enumerate(prompts)]
    for r in reqs:
        engine.submit(r)
    summary = engine.run_until_drained()
    for r in reqs:
        print(f"request {r.req_id} ({r.adapter_id}): tokens {r.output}")
    print("metrics:", {k: round(v, 4) if isinstance(v, float) else v
                       for k, v in summary.items()})
    return summary, {r.req_id: list(r.output) for r in reqs}


if __name__ == "__main__":
    main()
