"""Training launcher of the PyTorch port, the JAX package's
``launch/train.py``: train any registered arch (reduced or full config)
on the synthetic LM pipeline, full-parameter AdamW in fp32, and print
the same lines.

Example (on the card, the full config; ``--smoke --device cpu`` runs the
reduced one on the CPU):
  PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \\
      --steps 10 --batch 8 --seq 128 --log-every 1
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
      --steps 3

The VLM and the audio model get zero frontends, as in the reference.
``--checkpoint PATH`` saves the trained weights in the JAX tree's layout
(``bridge.params_to_numpy``), which needs ``msgpack``.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.bridge import params_to_numpy
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.training import (AdamWConfig, adamw_init, make_train_step,
                                  save_checkpoint)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    return ap.parse_args(argv)


def opt_config(args) -> AdamWConfig:
    """The launcher's AdamW: ``--lr``, warmup over a tenth of the steps
    (at most 20), cosine to the last step, weight decay 0.01."""
    return AdamWConfig(lr=args.lr, warmup_steps=min(20, args.steps // 10),
                       total_steps=args.steps, weight_decay=0.01)


def main(argv=None):
    """Runs the training; returns the logged steps' metrics, a list of
    {"step", "loss", "grad_norm", "lr", "seconds"} (seconds since the
    first step began, read after the step's values reached the host)."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(
        args.arch)
    params = M.init_params(cfg, 0, device=dev)
    n_params = sum(p.numel() for p in params.parameters())
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M")

    opt = adamw_init(params)
    step_fn = make_train_step(cfg, opt_config(args))

    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=args.seq, batch_size=args.batch))
    it = data.batches()
    log = []
    t0 = time.time()
    for step in range(1, args.steps + 1):
        toks, labels = next(it)
        batch = {"tokens": torch.from_numpy(toks).to(dev),
                 "labels": torch.from_numpy(labels).to(dev)}
        if cfg.family == "vlm":
            batch["frontend"] = torch.zeros(
                (args.batch, cfg.n_frontend_tokens, cfg.d_model), device=dev)
        if cfg.family == "audio":
            batch["frontend"] = torch.zeros(
                (args.batch, cfg.encoder.n_frames, cfg.d_model), device=dev)
        params, opt, m = step_fn(params, opt, batch)
        if step % args.log_every == 0 or step == 1:
            m = {k: float(v) for k, v in m.items()}
            seconds = time.time() - t0
            log.append({"step": step, **m, "seconds": seconds})
            tput = args.batch * args.seq * step / seconds
            print(f"step {step:5d} loss={m['loss']:.4f} "
                  f"gnorm={m['grad_norm']:.3f} "
                  f"lr={m['lr']:.2e} tok/s={tput:.0f}")
    if args.checkpoint:
        save_checkpoint(args.checkpoint, params_to_numpy(cfg, params))
        print(f"saved checkpoint to {args.checkpoint}")
    return log


if __name__ == "__main__":
    main()
