import os

# Tests see the single real CPU device; only launch/dryrun.py (run as its
# own process) forces 512 placeholder devices.
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_enable_x64", False)
# Pin the backend to the single real CPU device NOW, before any test
# module import can touch XLA_FLAGS (repro.launch.dryrun sets the
# 512-placeholder-device flag at import for its own __main__ use).
assert len(jax.devices()) == 1


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (the PyTorch port's kernels); "
        "skips where torch.cuda.is_available() is False")
