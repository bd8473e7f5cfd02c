"""PyTorch port, training against the JAX package on the dense and MoE
smoke configs (the JAX ``ARCH_IDS`` of those families; the others are in
``test_torch_train_families.py``): ``models.model.forward`` and
``loss_fn`` (h after ``ln_f``, the MoE balance loss, the loss), the
gradient of ``loss_fn`` for every leaf, and one ``make_train_step`` step
(the JAX ``adamw_update`` on the JAX gradients); remat on and off give
the same bits in the port; ``init_train_state`` and
``test_loss_decreases`` mirrored. Weights, inputs and tolerances:
``_torch_train_side.py`` (fp32, 1e-4 of the largest value)."""
import pytest
import torch

import _torch_train_side as T
from _torch_train_side import one_torch_thread  # noqa: F401 (fixture)
from repro.configs import ARCH_IDS, get_smoke_config
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.training import AdamWConfig, init_train_state, make_train_step

ARCHS = [a for a in ARCH_IDS
         if get_smoke_config(a).family in ("dense", "moe")]
pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch):
    T.check_forward(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_jax(arch):
    T.check_loss_and_grads(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gives_the_same_bits(arch):
    T.check_remat_bits(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_one_train_step_matches_jax(arch):
    """``test_models_smoke.py::test_one_train_step`` on the port, held
    against the JAX ``adamw_update`` on the JAX gradients."""
    T.check_one_train_step(arch)


def test_init_train_state():
    cfg = get_smoke_config("internlm2-1.8b")
    params, opt = init_train_state(cfg, 0, device="cpu")
    names = dict(params.named_parameters())
    assert set(opt["mu"]) == set(names) == set(opt["nu"])
    assert all(opt["mu"][k].dtype == torch.float32 and
               not opt["mu"][k].any() for k in names)
    assert int(opt["step"]) == 0
    with pytest.raises(RuntimeError):
        init_train_state(cfg, 0)                # no card: the default


def test_loss_decreases():
    """``tests/test_training.py::test_loss_decreases`` on the port."""
    cfg = get_smoke_config("stablelm-1.6b")
    params, opt = init_train_state(cfg, 0, device="cpu")
    oc = AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=100,
                     weight_decay=0.01)
    step = make_train_step(cfg, oc)
    it = SyntheticLM(DataConfig(cfg.vocab_size, 64, 8)).batches()
    losses = []
    for _ in range(40):
        t, l = next(it)
        params, opt, m = step(params, opt, {"tokens": torch.from_numpy(t),
                                            "labels": torch.from_numpy(l)})
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5
