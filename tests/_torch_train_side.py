"""The shared side of the PyTorch port's training tests
(``test_torch_train_step.py``, ``test_torch_train_families.py``,
``test_torch_lora_train.py``): JAX weights moved off their init values
and bridged, seeded batches with nonzero frontends, one jitted
``value_and_grad`` of the JAX loss a config (cached), the port's loss and
gradients, the checks each file runs on its configs, and the fixture
that runs them on one torch thread.

Weights are made by JAX and bridged (``repro_torch.bridge``), every
leaf moved off its init value by 0.1 N(0, 1) noise times its spread (1
for a constant leaf) and the VLM's gates set to 0.7 (0 at init, where
the cross blocks are the identity); the VLM and the audio model get a
nonzero N(0, 0.5^2) frontend. Inputs come from a numpy seed.

Tolerances (fp32): loss, h and aux within 1e-4 of the largest value;
every gradient and updated leaf within 1e-4 of the leaf's largest value,
with an absolute floor of 1e-6 for a leaf whose reference is all zero.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.models import model as JM
from repro.models.common import chunked_cross_entropy
from repro.training import AdamWConfig as JAdamWConfig
from repro.training import adamw_init as jadamw_init
from repro.training import adamw_update as jadamw_update
from repro_torch import bridge
from repro_torch.models import model as TM
from repro_torch.training import AdamWConfig, adamw_init, make_train_step

TOL = 1e-4
FLOOR = 1e-6
B, S = 2, 16


@pytest.fixture(scope="module")
def one_torch_thread():
    """The module's tests on one torch thread, the count restored after:
    the tests run many small ops, and beside five other workers a thread
    pool a worker (every core each) made ``test_loss_decreases`` 60x
    slower than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frontend_len(cfg):
    if cfg.family == "vlm":
        return cfg.n_frontend_tokens
    if cfg.family == "audio":
        return cfg.encoder.n_frames
    return None


def jax_params(cfg, seed=0):
    """JAX init, every leaf plus 0.1 N(0, 1) noise times its spread (1
    for a constant leaf: norms, biases, decays), the gates 0.7."""
    rng = np.random.default_rng(seed)

    def move(path, x):
        if "gate" in jax.tree_util.keystr(path):
            return jnp.full(x.shape, 0.7, x.dtype)
        sd = float(jnp.std(x)) or 1.0
        return x + (0.1 * sd * rng.standard_normal(x.shape)).astype(
            np.float32)
    jp = JM.init_params(cfg, jax.random.PRNGKey(seed))
    return jax.tree_util.tree_map_with_path(move, jp)


def batch_np(cfg, seed=1, b=B, s=S):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    M = _frontend_len(cfg)
    if M is not None:
        out["frontend"] = (rng.standard_normal((b, M, cfg.d_model)) * 0.5
                           ).astype(np.float32)
    return out


def t_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def close(got, want, what, tol=TOL):
    got = np.asarray(got.detach().float().numpy() if isinstance(
        got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = np.abs(want).max() if want.size else 0.0
    atol = tol * scale if scale > 0 else FLOOR
    err = np.abs(got - want).max() if want.size else 0.0
    assert err <= atol, f"{what}: {err} > {atol} (max {scale})"


def grads_in_jax_layout(cfg, module, grads):
    """``grads`` ({named_parameters name: tensor}) in the JAX tree's
    layout, through ``module``'s own structure (its values restored)."""
    like = {k: p.detach().clone() for k, p in module.named_parameters()}
    with torch.no_grad():
        for k, p in module.named_parameters():
            p.copy_(grads[k])
        out = bridge.params_to_numpy(cfg, module)
        for k, p in module.named_parameters():
            p.copy_(like[k])
    return out


def close_trees(got, want, what):
    """``got`` (numpy tree in the JAX layout) against the JAX tree."""
    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        g = got
        for k in path:
            g = g[k.key]
        close(g, np.asarray(w), f"{what}{jax.tree_util.keystr(path)}")


@functools.lru_cache(maxsize=None)
def jax_side(arch):
    """The JAX params, batch, and the one jitted value_and_grad of
    ``loss_fn`` (its aux: h and the balance loss) on them."""
    cfg = get_smoke_config(arch)
    jp = jax_params(cfg)
    batch = batch_np(cfg)

    def loss(p, b):
        h, aux = JM.forward(cfg, p, b["tokens"], frontend=b.get("frontend"),
                            remat=True)
        ce = chunked_cross_entropy(h, JM.lm_head(cfg, p), b["labels"])
        return ce + 0.01 * aux, (h, aux)

    (l, (h, aux)), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    return cfg, jp, batch, (float(l), np.asarray(h), float(aux), g)


def port_params(cfg, jp):
    return bridge.params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                                    device="cpu")


def port_loss_and_grads(cfg, module, batch, remat):
    named = dict(module.named_parameters())
    for p in named.values():
        p.requires_grad_(True)
    try:
        loss = TM.loss_fn(cfg, module, batch, remat=remat)
        gs = torch.autograd.grad(loss, list(named.values()),
                                 allow_unused=True)
    finally:
        for p in named.values():
            p.requires_grad_(False)
    return loss.detach(), {k: torch.zeros_like(p) if g is None else g
                           for (k, p), g in zip(named.items(), gs)}


def check_forward(arch):
    cfg, jp, batch, (_, jh, jaux, _) = jax_side(arch)
    tp = port_params(cfg, jp)
    tb = t_batch(batch)
    for remat in (False, True):
        h, aux = TM.forward(cfg, tp, tb["tokens"], frontend=tb.get("frontend"),
                            remat=remat)
        assert h.shape == (B, S, cfg.d_model) and aux.dtype == torch.float32
        close(h, jh, f"{arch} h remat={remat}")
        close(aux, np.float32(jaux), f"{arch} aux")
    if cfg.moe is not None:
        assert float(aux) > 0
    else:
        assert float(aux) == 0.0


def check_loss_and_grads(arch):
    cfg, jp, batch, (jl, _, _, jg) = jax_side(arch)
    tp = port_params(cfg, jp)
    loss, grads = port_loss_and_grads(cfg, tp, t_batch(batch), remat=True)
    close(loss, np.float32(jl), f"{arch} loss")
    close_trees(grads_in_jax_layout(cfg, tp, grads), jg, f"{arch} grad")
    # the frontend and the nonzero gates reach the encoder / cross blocks
    if cfg.family in ("vlm", "audio"):
        name = "cross_blocks.0.attn.wk" if cfg.family == "vlm" else \
            "enc_blocks.0.attn.wq"
        assert grads[name].abs().max() > 0


def check_remat_bits(arch):
    cfg, jp, batch, _ = jax_side(arch)
    tp = port_params(cfg, jp)
    tb = t_batch(batch)
    l0, g0 = port_loss_and_grads(cfg, tp, tb, remat=False)
    l1, g1 = port_loss_and_grads(cfg, tp, tb, remat=True)
    assert torch.equal(l0, l1)
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k


def check_one_train_step(arch):
    """``test_models_smoke.py::test_one_train_step`` on the port, held
    against the JAX ``adamw_update`` on the JAX gradients."""
    cfg, jp, batch, (jl, _, _, jg) = jax_side(arch)
    jp2, jopt2, jm = jax.jit(functools.partial(
        jadamw_update, JAdamWConfig(lr=1e-3)))(jg, jadamw_init(jp), jp)
    tp = port_params(cfg, jp)
    before = {k: p.detach().clone() for k, p in tp.named_parameters()}
    opt = adamw_init(tp)
    step = make_train_step(cfg, AdamWConfig(lr=1e-3))
    tp2, opt2, m = step(tp, opt, t_batch(batch))
    assert tp2 is tp
    assert torch.isfinite(m["loss"]) and float(m["grad_norm"]) > 0
    close(m["loss"], np.float32(jl), f"{arch} loss")
    close(m["grad_norm"], np.float32(jm["grad_norm"]), f"{arch} grad_norm")
    close(m["lr"], np.float32(jm["lr"]), f"{arch} lr", tol=1e-6)
    assert int(opt2["step"]) == 1 and opt2["step"].dtype == torch.int32
    assert any(not torch.equal(p, before[k])
               for k, p in tp.named_parameters())
    assert not any(p.requires_grad for p in tp.parameters())
    close_trees(bridge.params_to_numpy(cfg, tp), jp2, f"{arch} param")
    for key in ("mu", "nu"):
        close_trees(grads_in_jax_layout(cfg, tp, opt2[key]), jopt2[key],
                    f"{arch} {key}")
