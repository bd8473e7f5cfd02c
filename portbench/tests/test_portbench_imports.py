"""What the benchmark runs loads neither JAX nor the JAX package, reads
nothing of ``benchmarks/``, and its reference takes nothing of the
program: every module's imports, by whole top-level name."""
import ast
from pathlib import Path

import pytest

PB = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def modules():
    return sorted(p for p in PB.rglob("*.py") if "tests" not in p.parts)


def top_names(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", modules(), ids=lambda p: p.name)
def test_no_jax_and_no_benchmarks_folder(path):
    assert not top_names(path) & FORBIDDEN
    assert "benchmarks/" not in path.read_text()


def test_the_comparison_is_by_whole_name():
    # the port's name begins with the JAX package's; it is not refused
    used = set().union(*map(top_names, modules()))
    assert "repro_torch" in used and not used & FORBIDDEN


@pytest.mark.parametrize("path", sorted(PB.glob("arch/*_ref.py")) +
                         [PB / "arch" / "ref_common.py"],
                         ids=lambda p: p.name)
def test_references_take_nothing_of_the_program(path):
    assert top_names(path) <= {"torch", "__future__"}


def test_the_run_refuses_a_process_that_loaded_jax(monkeypatch):
    import sys

    from portbench import harness
    monkeypatch.setattr(sys, "modules", dict.fromkeys(
        ["os", "jax._src.api", "repro_torch.serving", "reprox"]))
    assert harness.forbidden_modules() == ["jax"]


def test_no_card_no_result(monkeypatch, capsys):
    import torch

    from portbench import run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "qwen2.5-32b-l32.batch", "--seed", "1",
                     "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""
