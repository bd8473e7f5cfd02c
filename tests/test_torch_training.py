"""PyTorch port, the training substrate against the JAX package: AdamW
(``adamw_update`` with and without a mask, clipping active,
``lr_schedule`` at step 0, in warmup, mid-decay and past the end,
``global_norm``) on random trees; ``chunked_cross_entropy`` with S below,
equal to and not a multiple of the chunk, -1 labels among them, and its
gradient; checkpoints written by either package read by the other
(params through ``bridge.params_to_numpy``, an adapter, bf16); the data
pipeline (an exact copy); the kernel wrappers' refusal under autograd,
and that the training forward calls none of them; ``launch/train.py``
and ``examples/train_lora.py`` on the CPU. ``tests/test_training.py``'s
optimizer and pipeline cases are mirrored.

Tolerances: fp32 1e-6 relative on the optimizer (the same operations in
the same order on the same inputs; only the summation order of the
global norm over leaves differs), 1e-5 of the largest value on the
cross entropy and its gradient; checkpoints and the pipeline exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_train_side import one_torch_thread  # noqa: F401 (fixture)
from repro.configs import get_smoke_config
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLM as JSyntheticLM
from repro.models import model as JM
from repro.models.common import chunked_cross_entropy as jce
from repro.training import AdamWConfig as JAdamWConfig
from repro.training import adamw_init as jadamw_init
from repro.training import adamw_update as jadamw_update
from repro.training import global_norm as jglobal_norm
from repro.training import load_checkpoint as jload
from repro.training import lr_schedule as jlr_schedule
from repro.training import save_checkpoint as jsave
from repro_torch import bridge
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.examples import train_lora
from repro_torch.kernels import flash, sgmv
from repro_torch.launch import train as train_launcher
from repro_torch.lora.adapter import _target_in_dim, _target_out_dim
from repro_torch.models import model as TM
from repro_torch.models.common import chunked_cross_entropy
from repro_torch.training import (AdamWConfig, adamw_init, adamw_update,
                                  global_norm, load_checkpoint, lr_schedule,
                                  save_checkpoint)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= rtol * scale, what


pytestmark = pytest.mark.usefixtures("one_torch_thread")


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------


def _tree(rng, scale=1.0):
    def r(*shape):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    return {"blocks": {"w": r(3, 4, 5), "b": r(3, 5)}, "embed": r(7, 4),
            "ln": [r(4)]}


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("clip", [False, True])
def test_adamw_update_matches_jax(masked, clip):
    rng = np.random.default_rng(int(masked) * 2 + int(clip))
    p, g = _tree(rng), _tree(rng, scale=50.0 if clip else 0.01)
    cfg = dict(lr=1e-2, warmup_steps=3, total_steps=10, weight_decay=0.1)
    mask = {"blocks": {"w": True, "b": False}, "embed": True,
            "ln": [False]} if masked else None
    jp, jg = jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, g)
    tp, tg = jax.tree.map(_t, p), jax.tree.map(_t, g)
    jo, to = jadamw_init(jp), adamw_init(tp)
    for _ in range(3):                          # moments and bias terms
        jp, jo, jm = jadamw_update(JAdamWConfig(**cfg), jg, jo, jp, mask)
        tp, to, tm = adamw_update(AdamWConfig(**cfg), tg, to, tp, mask)
        _close(tm["grad_norm"], jm["grad_norm"], 1e-6)
        _close(tm["lr"], jm["lr"], 1e-6)
        assert (float(tm["grad_norm"]) > 1.0) == clip
        for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(tp)):
            _close(b, a, 1e-6)
        for key in ("mu", "nu"):
            for a, b in zip(jax.tree.leaves(jo[key]),
                            jax.tree.leaves(to[key])):
                _close(b, a, 1e-6)
        assert int(to["step"]) == int(jo["step"])
        assert to["step"].dtype == torch.int32
    if masked:
        assert torch.equal(tp["blocks"]["b"], _t(p["blocks"]["b"]))
        assert not to["mu"]["ln"][0].any()


@pytest.mark.parametrize("step", [0, 1, 5, 10, 55, 100, 101, 250])
def test_lr_schedule_matches_jax(step):
    cfg = dict(lr=3e-3, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    got = lr_schedule(AdamWConfig(**cfg), torch.tensor(step,
                                                       dtype=torch.int32))
    want = jlr_schedule(JAdamWConfig(**cfg), jnp.asarray(step, jnp.int32))
    assert got.dtype == torch.float32
    _close(got, want, 1e-6)


def test_global_norm_matches_jax():
    rng = np.random.default_rng(3)
    p = _tree(rng)
    _close(global_norm(jax.tree.map(_t, p)),
           jglobal_norm(jax.tree.map(jnp.asarray, p)), 1e-6)


def test_adamw_clipping():
    """``tests/test_training.py::test_adamw_clipping`` on the port."""
    p = {"w": torch.ones(4)}
    g = {"w": torch.full((4,), 100.0)}
    opt = adamw_init(p)
    cfg = AdamWConfig(lr=1e-2, clip_norm=1.0, warmup_steps=0,
                      weight_decay=0.0)
    p2, opt2, m = adamw_update(cfg, g, opt, p)
    assert float(m["grad_norm"]) == pytest.approx(200.0)
    assert bool(torch.all(p2["w"] < p["w"]))
    assert int(opt2["step"]) == 1


def test_trainable_mask_freezes():
    """``tests/test_training.py::test_trainable_mask_freezes`` on the
    port."""
    p = {"a": torch.ones(2), "b": torch.ones(2)}
    g = {"a": torch.ones(2), "b": torch.ones(2)}
    opt = adamw_init(p)
    cfg = AdamWConfig(lr=1e-2, warmup_steps=0)
    p2, _, _ = adamw_update(cfg, g, opt, p,
                            trainable_mask={"a": True, "b": False})
    assert bool(torch.all(p2["a"] != p["a"]))
    assert torch.equal(p2["b"], p["b"])


# ---------------------------------------------------------------------------
# chunked cross entropy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S,chunk", [(5, 8), (8, 8), (13, 4), (16, 4)])
def test_chunked_cross_entropy_matches_jax(S, chunk):
    rng = np.random.default_rng(S)
    B, d, V = 3, 16, 40
    h = rng.standard_normal((B, S, d)).astype(np.float32)
    w = rng.standard_normal((d, V)).astype(np.float32) * 0.3
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    labels[0, 1] = labels[2, S - 1] = -1        # ignored positions

    def jloss(h, w):
        return jce(h, w, jnp.asarray(labels), chunk=chunk)
    jl, (jgh, jgw) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(w))
    th, tw = _t(h).requires_grad_(True), _t(w).requires_grad_(True)
    tl = chunked_cross_entropy(th, tw, _t(labels), chunk=chunk)
    tl.backward()
    _close(tl, jl, 1e-5)
    _close(th.grad, jgh, 1e-5)
    _close(tw.grad, jgw, 1e-5)
    assert not th.grad[0, 1].any() and not th.grad[2, S - 1].any()
    with torch.no_grad():
        _close(chunked_cross_entropy(_t(h), _t(w), _t(labels), chunk=chunk),
               jl, 1e-5)


# ---------------------------------------------------------------------------
# checkpoints across the two packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "zamba2-7b"])
def test_params_checkpoint_port_to_jax(tmp_path, arch):
    cfg = get_smoke_config(arch)
    tp = TM.init_params(cfg, 3, device="cpu")
    path = str(tmp_path / "p.msgpack")
    save_checkpoint(path, bridge.params_to_numpy(cfg, tp))
    like = JM.init_params(cfg, jax.random.PRNGKey(0))
    got = jload(path, like)
    want = bridge.params_to_numpy(cfg, tp)
    assert jax.tree.structure(got) == jax.tree.structure(like)
    for (path_, a) in jax.tree_util.tree_flatten_with_path(got)[0]:
        b = want
        for k in path_:
            b = b[k.key]
        np.testing.assert_array_equal(np.asarray(a), b)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "zamba2-7b"])
def test_params_checkpoint_jax_to_port(tmp_path, arch):
    cfg = get_smoke_config(arch)
    jp = JM.init_params(cfg, jax.random.PRNGKey(4))
    path = str(tmp_path / "p.msgpack")
    jsave(path, jp)
    like = bridge.params_to_numpy(cfg, TM.init_params(cfg, 0, device="cpu"))
    tree = load_checkpoint(path, like)
    tp = bridge.params_from_numpy(
        cfg, jax.tree.map(lambda t: t.numpy(), tree), device="cpu")
    back = bridge.params_to_numpy(cfg, tp)
    for (path_, a) in jax.tree_util.tree_flatten_with_path(jp)[0]:
        b = back
        for k in path_:
            b = b[k.key]
        np.testing.assert_array_equal(np.asarray(a), b)


def _adapter(seed):
    rng = np.random.default_rng(seed)
    return {t: {"A": rng.standard_normal((2, 8, 4)).astype(np.float32),
                "B": rng.standard_normal((2, 4, 6)).astype(np.float32)}
            for t in ("q", "k", "v", "o")}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adapter_checkpoint_both_ways(tmp_path, dtype):
    w = _adapter(1)
    jw = jax.tree.map(lambda a: jnp.asarray(a, dtype), w)
    tw = jax.tree.map(lambda a: _t(a).to(getattr(torch, dtype)), w)
    # port -> JAX
    path = str(tmp_path / "t.msgpack")
    save_checkpoint(path, tw)
    got = jload(path, jw)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jw)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))
    # JAX -> port
    path = str(tmp_path / "j.msgpack")
    jsave(path, jw)
    got = load_checkpoint(path, tw)
    for t in w:
        for k in ("A", "B"):
            assert got[t][k].dtype == tw[t][k].dtype
            assert torch.equal(got[t][k], tw[t][k])


def test_checkpoint_roundtrip_and_shape_check(tmp_path):
    """``tests/test_training.py::test_checkpoint_roundtrip`` on the port:
    params and AdamW state together; a mismatched shape refuses."""
    cfg = get_smoke_config("internlm2-1.8b")
    params = TM.init_params(cfg, 2, device="cpu")
    state = {"params": bridge.params_to_numpy(cfg, params),
             "opt": adamw_init(params)}
    path = str(tmp_path / "ck.msgpack")
    save_checkpoint(path, state)
    restored = load_checkpoint(path, state)
    a = jax.tree.leaves(state, is_leaf=lambda x: isinstance(x, torch.Tensor))
    b = jax.tree.leaves(restored,
                        is_leaf=lambda x: isinstance(x, torch.Tensor))
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())
    bad = {"params": dict(state["params"], ln_f=np.zeros(3, np.float32)),
           "opt": state["opt"]}
    with pytest.raises(ValueError):
        load_checkpoint(path, bad)


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------


def test_data_pipeline_deterministic():
    """``tests/test_training.py::test_data_pipeline_deterministic`` on the
    port, and the same batches as the JAX package's pipeline."""
    c = DataConfig(vocab_size=128, seq_len=16, batch_size=2, seed=3)
    a1 = next(SyntheticLM(c).batches())
    a2 = next(SyntheticLM(c).batches())
    np.testing.assert_array_equal(a1[0], a2[0])
    np.testing.assert_array_equal(a1[0][:, 1:], a1[1][:, :-1])
    it = SyntheticLM(c).batches()
    jit = JSyntheticLM(JDataConfig(vocab_size=128, seq_len=16,
                                   batch_size=2, seed=3)).batches()
    for _ in range(3):
        for x, y in zip(next(it), next(jit)):
            np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# the kernel wrappers refuse autograd; the training forward calls none
# ---------------------------------------------------------------------------


def _wrapper_call(name):
    """(wrapper, its CPU arguments, the weight to make require grad)."""
    rng = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(shape, generator=rng)
    blk = torch.zeros(2, dtype=torch.int32)
    A, B = r(2, 8, 4), r(2, 4, 6)
    if name == "flash_mha":
        q = r(1, 2, 8, 16)
        return flash.flash_mha, (q, r(1, 2, 8, 16), r(1, 2, 8, 16)), q
    if name == "sgmv_fused_blocks":
        return sgmv.sgmv_fused_blocks, (r(32, 8), A, B, blk), A
    if name == "sgmv_multibank_blocks":
        return sgmv.sgmv_multibank_blocks, (r(32, 8), [(A, B)], blk,
                                            blk), B
    if name == "sgmv_shrink":
        return sgmv.sgmv_shrink, (r(32, 8), A, blk), A
    if name == "sgmv_expand":
        return sgmv.sgmv_expand, (r(32, 4), B, blk), B
    if name == "sgmv_multibank_shrink":
        return sgmv.sgmv_multibank_shrink, (r(32, 8), [A], blk, blk), A
    return sgmv.sgmv_multibank_expand, (r(32, 4), [B], blk, blk), B


WRAPPERS = ["flash_mha", "sgmv_fused_blocks", "sgmv_multibank_blocks",
            "sgmv_shrink", "sgmv_expand", "sgmv_multibank_shrink",
            "sgmv_multibank_expand"]


@pytest.mark.parametrize("name", WRAPPERS)
def test_kernel_wrappers_refuse_autograd(name):
    fn, args, w = _wrapper_call(name)
    plain = fn(*args)                     # nothing requires grad: served
    w.requires_grad_(True)
    with pytest.raises(RuntimeError, match="requires grad"):
        fn(*args)
    with torch.no_grad():                 # grad mode off: served as before
        assert torch.equal(fn(*args), plain)


@pytest.mark.parametrize("arch", ["llama-7b-paper",
                                  "seamless-m4t-large-v2"])
def test_training_forward_calls_no_kernel(monkeypatch, arch):
    """Every wrapper's first act is ``refuse_autograd``: recording its
    calls counts the wrappers' calls on any device. The training forward
    and its backward call none; the serving prefill of the same model
    and bank calls B5 and the SGMV kernels (MHA from position 0; the
    audio model's encoder, decoder and cross-attention)."""
    calls = []
    for mod in (flash, sgmv):
        real = mod.refuse_autograd
        monkeypatch.setattr(mod, "refuse_autograd",
                            lambda name, *a, real=real:
                            (calls.append(name), real(name, *a)))
    cfg = get_smoke_config(arch)
    params = TM.init_params(cfg, 0, device="cpu")
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 8)))
    fe = torch.from_numpy(rng.standard_normal(
        (2, cfg.encoder.n_frames, cfg.d_model)).astype(np.float32)) \
        if cfg.family == "audio" else None
    adapter = {t: {"A": torch.randn(cfg.n_layers, 1,
                                    _target_in_dim(cfg, t), 4),
                   "B": torch.randn(cfg.n_layers, 1, 4,
                                    _target_out_dim(cfg, t))}
               for t in cfg.lora.targets}
    for d in adapter.values():
        for w in d.values():
            w.requires_grad_(True)
    idx = torch.zeros(2, dtype=torch.int32)
    for p in params.parameters():
        p.requires_grad_(True)
    h, aux = TM.forward(cfg, params, tokens, frontend=fe, bank=adapter,
                        lora_idx=idx, remat=True)
    (h.square().mean() + aux).backward()
    assert calls == []
    assert params.embed.grad.abs().max() > 0
    assert all(adapter[t]["A"].grad.abs().max() > 0 for t in adapter)
    for p in params.parameters():
        p.requires_grad_(False)
    with torch.no_grad():
        TM.prefill(cfg, params, tokens, frontend=fe,
                   bank={t: {k: v.detach() for k, v in d.items()}
                         for t, d in adapter.items()},
                   lora_idx=idx, lora_kernel="sgmv")
    assert "flash_mha" in calls and "sgmv_fused_blocks" in calls
    # an sgmv LoRA in the forward under grad trips the guard
    with pytest.raises(RuntimeError, match="requires grad"):
        TM.forward(cfg, params, tokens, frontend=fe, bank=adapter,
                   lora_idx=idx, lora_kernel="sgmv")


# ---------------------------------------------------------------------------
# launcher and example
# ---------------------------------------------------------------------------


def test_train_launcher_smoke_on_cpu(tmp_path, capsys):
    path = str(tmp_path / "ck.msgpack")
    log = train_launcher.main(["--smoke", "--device", "cpu", "--steps", "3",
                               "--log-every", "1", "--checkpoint", path])
    out = capsys.readouterr().out
    assert out.splitlines()[0] == "arch=internlm2-1.8b-smoke params=0.4M"
    assert [m["step"] for m in log] == [1, 2, 3]
    cfg = train_launcher.opt_config(train_launcher.parse_args(
        ["--steps", "3"]))
    assert cfg == AdamWConfig(lr=3e-3, warmup_steps=0, total_steps=3,
                              weight_decay=0.01)
    for m, line in zip(log, out.splitlines()[1:4]):
        assert np.isfinite(m["loss"]) and m["grad_norm"] > 0
        lr = float(lr_schedule(cfg, torch.tensor(m["step"])))
        assert f"lr={lr:.2e}" in line and line.startswith(
            f"step {m['step']:5d} loss={m['loss']:.4f}")
    assert f"saved checkpoint to {path}" in out
    jcfg = get_smoke_config("internlm2-1.8b")
    restored = jload(path, JM.init_params(jcfg, jax.random.PRNGKey(0)))
    assert all(np.isfinite(np.asarray(x)).all()
               for x in jax.tree.leaves(restored))


def test_train_launcher_refuses_without_a_card():
    with pytest.raises(RuntimeError, match="cuda"):
        train_launcher.main(["--smoke", "--steps", "1"])


def test_train_lora_example_on_cpu(tmp_path, capsys):
    out = train_lora.main(["--device", "cpu", "--dim", "64", "--layers", "2",
                           "--steps", "3", "--lora-steps", "2",
                           "--out-dir", str(tmp_path)])
    text = capsys.readouterr().out
    assert out["serving"]["finished"] == 2
    assert "checkpoints saved:" in text and "serving metrics:" in text
    adapter = out["adapter"]
    got = load_checkpoint(out["adapter_path"], adapter)
    for t in adapter:
        for k in ("A", "B"):
            assert torch.equal(got[t][k], adapter[t][k])
        assert adapter[t]["B"].abs().max() > 0           # tuned off zero
    base = load_checkpoint(out["base_path"],
                           bridge.params_to_numpy(out["cfg"], out["params"]))
    want = dict(out["params"].named_parameters())
    assert torch.equal(base["ln_f"], want["ln_f"])
    assert torch.equal(base["blocks"]["attn"]["wq"][1],
                       want["blocks.1.attn.wq"])
