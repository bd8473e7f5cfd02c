"""PyTorch port, LoRA fine-tuning against the JAX package: three
``make_lora_train_step`` steps on llama-7b-paper, deepseek-v2-lite-16b
(MLA), zamba2-7b (the hybrid), rwkv6-7b, seamless-m4t-large-v2 and the
VLM, each from the same bridged base and nonzero adapter as the JAX
step (jitted once a config) on the same batches: the losses, the
adapter and the AdamW moments after each step agree, and the base stays
bit for bit what it was. The reference's behaviours come along
(ROADMAP C3, C9): no adapter reaches the VLM, so its moments stay 0 and
only the weight decay moves A and B; MLA never applies its ``v``
adapter; the hybrid trains layer 0 of its adapter only (one shared
block binds bank layer 0).

Weights, batches (nonzero frontends, the VLM's gates 0.7) and
tolerances: ``_torch_train_side.py`` (fp32, 1e-4 of each leaf's largest
value, floor 1e-6 for an all-zero leaf)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_train_side as T
from _torch_train_side import one_torch_thread  # noqa: F401 (fixture)
from repro.configs import get_smoke_config
from repro.lora.adapter import _target_in_dim, _target_out_dim
from repro.training import AdamWConfig as JAdamWConfig
from repro.training import adamw_init as jadamw_init
from repro.training import make_lora_train_step as jmake_lora_train_step
from repro_torch.training import (AdamWConfig, adamw_init,
                                  make_lora_train_step)

ARCHS = ["llama-7b-paper", "deepseek-v2-lite-16b", "zamba2-7b", "rwkv6-7b",
         "seamless-m4t-large-v2", "llama-3.2-vision-90b"]
pytestmark = pytest.mark.usefixtures("one_torch_thread")
RANK = 8
STEPS = 3
# eps 1e-3, not the default 1e-8: Adam's step is g / (|g| + eps), a sign
# for |g| >> eps, and an entry whose gradient lies within the two
# frameworks' rounding of 0 (zamba2's v A has one at 2.4e-7, the
# gradients differ by up to 3.6e-6) would flip its step by 2 lr. With
# eps 1e-3 the step is a smooth function of the gradient there, so the
# adapters compare what the gradients are.
OPT = dict(lr=1e-3, eps=1e-3, warmup_steps=1, total_steps=20)


def adapter_np(cfg, seed=5):
    """One adapter {target: {"A": (L, d_in, r), "B": (L, r, d_out)}} over
    every layer (the JAX ``init_adapter``'s shapes), A and B nonzero."""
    rng = np.random.default_rng(seed)
    L = cfg.n_layers
    return {t: {"A": (rng.standard_normal((L, _target_in_dim(cfg, t), RANK))
                      * 0.2).astype(np.float32),
                "B": (rng.standard_normal((L, RANK, _target_out_dim(cfg, t)))
                      * 0.2).astype(np.float32)}
            for t in cfg.lora.targets}


@functools.lru_cache(maxsize=None)
def runs(arch):
    """(cfg, the port's base module, its digest before, the three steps'
    (port, JAX) adapters, opt states and losses)."""
    cfg = get_smoke_config(arch)
    jp = T.jax_params(cfg)
    w = adapter_np(cfg)
    batches = [T.batch_np(cfg, seed=10 + i) for i in range(STEPS)]

    jstep = jax.jit(jmake_lora_train_step(cfg, JAdamWConfig(**OPT)))
    ja = jax.tree.map(jnp.asarray, w)
    jo = jadamw_init(ja)
    jout = []
    for b in batches:
        ja, jo, jm = jstep(ja, jo, jp, {k: jnp.asarray(v)
                                        for k, v in b.items()})
        jout.append((jax.tree.map(np.asarray, ja),
                     jax.tree.map(np.asarray, jo), float(jm["loss"])))

    base = T.port_params(cfg, jp)
    before = {k: p.detach().clone() for k, p in base.named_parameters()}
    step = make_lora_train_step(cfg, AdamWConfig(**OPT))
    ta = {t: {k: torch.from_numpy(v.copy()) for k, v in d.items()}
          for t, d in w.items()}
    to = adamw_init(ta)
    tout = []
    for b in batches:
        ta, to, tm = step(ta, to, base, T.t_batch(b))
        tout.append((ta, to, tm))
    return cfg, base, before, w, tout, jout


def _np(tree):
    return jax.tree.map(lambda t: t.numpy(), tree)


@pytest.mark.parametrize("arch", ARCHS)
def test_three_lora_steps_match_jax(arch):
    cfg, base, before, _, tout, jout = runs(arch)
    for i, ((ta, to, tm), (ja, jo, jl)) in enumerate(zip(tout, jout)):
        T.close(tm["loss"], np.float32(jl), f"{arch} step {i} loss")
        T.close_trees(_np(ta), ja, f"{arch} step {i} adapter")
        for key in ("mu", "nu"):
            T.close_trees(_np(to[key]), jo[key], f"{arch} step {i} {key}")
        assert int(to["step"]) == i + 1
        assert not any(t.requires_grad for t in jax.tree.leaves(
            ta, is_leaf=lambda x: isinstance(x, torch.Tensor)))
    for k, p in base.named_parameters():
        assert torch.equal(p, before[k]), k
        assert not p.requires_grad


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_behaviours(arch):
    """Which adapter entries get a gradient, read from the first moment
    after three steps (exactly 0 where no gradient ever reached), and the
    weight decay moving every leaf."""
    cfg, _, _, w, tout, _ = runs(arch)
    ta, to, _ = tout[-1]
    for t, d in to["mu"].items():
        for k, mu in d.items():
            assert not torch.equal(ta[t][k], torch.from_numpy(w[t][k])), \
                (t, k)                    # decay moves even a frozen leaf
            if cfg.family == "vlm" or (cfg.mla is not None and t == "v"):
                live = torch.zeros(mu.shape[0], dtype=torch.bool)
            elif cfg.family == "hybrid":
                live = torch.arange(mu.shape[0]) == 0
            else:
                live = torch.ones(mu.shape[0], dtype=torch.bool)
            for layer in range(mu.shape[0]):
                moved = bool(mu[layer].abs().max() > 0)
                assert moved == bool(live[layer]), (arch, t, k, layer)
