"""PyTorch port, training against the JAX package on the hybrid, SSM,
VLM and audio smoke configs (zamba2, rwkv6, llama-3.2-vision,
seamless-m4t; the dense and MoE configs are in
``test_torch_train_step.py``): ``forward`` and ``loss_fn``, every
gradient, one ``make_train_step`` step against the JAX package, remat
on == off bit for bit. The VLM's gates are nonzero and both
frontend-taking families get a nonzero frontend, so the encoder, the
cross blocks and their gradients are reached. Weights, inputs and
tolerances: ``_torch_train_side.py``."""
import pytest

import _torch_train_side as T
from _torch_train_side import one_torch_thread  # noqa: F401 (fixture)
from repro.configs import ARCH_IDS, get_smoke_config

ARCHS = [a for a in ARCH_IDS
         if get_smoke_config(a).family in ("hybrid", "ssm", "vlm", "audio")]
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
