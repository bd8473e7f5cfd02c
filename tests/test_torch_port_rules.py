"""PyTorch port, package rules: nothing in ``src/repro_torch``,
``chip_smoke.py`` or ``tests/_torch_tp_rank.py`` imports JAX or the JAX
package, and the port's copies of the JAX package's pure-Python modules
have not drifted."""
import ast
import dataclasses
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
# the port, chip_smoke.py, and the module that tensor-parallel test ranks
# import (they must not import JAX)
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py", ROOT / "tests" / "_torch_tp_rank.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_neither_jax_nor_repro(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_tree_is_scanned():
    names = {p.name for p in PORT_FILES}
    assert {"engine.py", "sgmv.py", "ops.py", "model.py", "bridge.py",
            "mesh.py", "sharding.py", "_torch_tp_rank.py",
            "chip_smoke.py"} <= names


@pytest.mark.parametrize("getter", ["get_config", "get_smoke_config"])
def test_llama_configs_equal_the_jax_package(getter):
    import repro.configs as jcfg
    import repro_torch.configs as tcfg
    a = dataclasses.asdict(getattr(jcfg, getter)("llama-7b-paper"))
    b = dataclasses.asdict(getattr(tcfg, getter)("llama-7b-paper"))
    assert a == b


def test_request_and_metrics_copies_match():
    """The copied request type and metrics collector behave as the JAX
    package's on the same lifecycle."""
    from repro.core.request import Request as JReq
    from repro.serving.metrics import MetricsCollector as JMC
    from repro_torch.core.request import Request as TReq
    from repro_torch.serving.metrics import MetricsCollector as TMC
    sums = []
    for Req, MC in ((JReq, JMC), (TReq, TMC)):
        mc = MC()
        for i in range(5):
            r = Req(i, "a", [1, 2, 3], 4, arrival=0.5 * i)
            r.t_first_token, r.t_finish = 1.0 + i, 2.0 + 1.5 * i
            r.output = [7] * (1 + i % 3)
            mc.record(r)
        sums.append(mc.summary())
    assert sums[0].keys() == sums[1].keys()
    for k in sums[0]:
        assert sums[0][k] == pytest.approx(sums[1][k], nan_ok=True)
