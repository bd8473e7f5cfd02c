"""Train a base model, then fine-tune a LoRA adapter on it and serve
both through the engine — the full lifecycle that feeds the paper's
serving system; the port's counterpart of the JAX package's
``examples/train_lora.py``, with its flags and lines.

Defaults train a ~13M-param model for 150 steps; ``--device cpu`` runs
on the CPU (the kernels' plain versions serve), the default is the card.
A ~100M model is --dim 512 --layers 8 --steps 300.

  PYTHONPATH=src python -m repro_torch.examples.train_lora [--steps 150]
  PYTHONPATH=src python -m repro_torch.examples.train_lora --device cpu \\
      --dim 64 --layers 2 --steps 3 --lora-steps 2 --out-dir /tmp/x

Checkpoints (``--out-dir``: base.msgpack in the JAX tree's layout,
adapter.msgpack) need ``msgpack``.
"""
import argparse
import dataclasses
import os
import time

import torch

from repro_torch.bridge import params_to_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.lora.adapter import init_adapter
from repro_torch.models import model as M
from repro_torch.serving import Request, ServingEngine
from repro_torch.training import (AdamWConfig, adamw_init,
                                  make_lora_train_step, make_train_step,
                                  save_checkpoint)


def _batch(toks, labels, dev):
    return {"tokens": torch.from_numpy(toks).to(dev),
            "labels": torch.from_numpy(labels).to(dev)}


def main(argv=None):
    """Runs the lifecycle; returns {"cfg", "params", "adapter",
    "base_path", "adapter_path", "serving"}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--lora-steps", type=int, default=50)
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--rank", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--out-dir", default="/tmp",
                    help="where base.msgpack and adapter.msgpack go")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = dataclasses.replace(get_smoke_config("llama-7b-paper"),
                              d_model=args.dim, n_layers=args.layers,
                              n_heads=args.dim // 32,
                              n_kv_heads=args.dim // 32,
                              d_ff=args.dim * 3)
    params = M.init_params(cfg, 0, device=dev)
    n = sum(p.numel() for p in params.parameters())
    print(f"base model: {n / 1e6:.1f}M params")

    # --- pretrain the base
    oc = AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=args.steps,
                     weight_decay=0.01)
    step = make_train_step(cfg, oc)
    opt = adamw_init(params)
    it = SyntheticLM(DataConfig(cfg.vocab_size, 64, 8, seed=0)).batches()
    t0 = time.time()
    for s in range(1, args.steps + 1):
        params, opt, m = step(params, opt, _batch(*next(it), dev))
        if s % 25 == 0 or s == 1:
            print(f"pretrain step {s:4d} loss={float(m['loss']):.3f} "
                  f"({8 * 64 * s / (time.time() - t0):.0f} tok/s)")

    # --- LoRA fine-tune on a *different* synthetic distribution
    adapter = init_adapter(cfg, args.rank,
                           torch.Generator(device=dev).manual_seed(0))
    aopt = adamw_init(adapter)
    loc = AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=args.lora_steps)
    lstep = make_lora_train_step(cfg, loc)
    ft = SyntheticLM(DataConfig(cfg.vocab_size, 64, 8, seed=99)).batches()
    for s in range(1, args.lora_steps + 1):
        adapter, aopt, m = lstep(adapter, aopt, params,
                                 _batch(*next(ft), dev))
        if s % 25 == 0 or s == 1:
            print(f"lora step {s:4d} loss={float(m['loss']):.3f}")

    base_path = os.path.join(args.out_dir, "base.msgpack")
    adapter_path = os.path.join(args.out_dir, "adapter.msgpack")
    save_checkpoint(base_path, params_to_numpy(cfg, params))
    save_checkpoint(adapter_path, adapter)
    print(f"checkpoints saved: {base_path} {adapter_path}")

    # --- serve base + adapter together
    engine = ServingEngine(cfg, params, {"base-like": args.rank,
                                         "tuned": args.rank},
                           max_batch=2, max_len=48, device=dev)
    engine.install_adapter("tuned", args.rank, weights=adapter)
    now = time.monotonic()
    engine.submit(Request(0, "base-like", [5, 9, 2, 41], 6, arrival=now))
    engine.submit(Request(1, "tuned", [5, 9, 2, 41], 6, arrival=now))
    summ = engine.run_until_drained()
    print("serving metrics:", {k: round(v, 3) if isinstance(v, float)
                               else v for k, v in summ.items()})
    return {"cfg": cfg, "params": params, "adapter": adapter,
            "base_path": base_path,
            "adapter_path": adapter_path, "serving": summ}


if __name__ == "__main__":
    main()
