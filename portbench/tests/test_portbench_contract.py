"""BENCHMARK.json against the benchmark's contract, and every file it
names by name is there."""
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
B = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_keys_and_limits():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= B["run_seconds"] <= 51
    assert B["paths"] == ["portbench"]
    assert len(json.dumps(B)) < 64 * 1024


def test_names_units_and_files():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in B[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in B["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith(
            "portbench/")
        assert all(NAME.match(k) for k in c["reduced"])
    for m in B["end_to_end"] + B["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").is_file()
    for w in B["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (ROOT / "portbench" / "cells" / f"{w['name']}.json").is_file()
        assert (ROOT / "portbench" / "traffic" /
                f"{w['traffic']}.json").is_file()


def test_bounds():
    for m in B["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert [m["bound"] for m in B["end_to_end"]
            if m["name"] == "setup_s"] == [0.25]


@pytest.mark.parametrize("w", B["workloads"], ids=lambda w: w["name"])
def test_every_cell_reports_setup_another_metric_and_a_layer(w):
    def mine(m):
        return "workloads" not in m or w["name"] in m["workloads"]
    e2e = {m["name"] for m in B["end_to_end"] if mine(m)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layers = [m for m in B["per_layer"] if mine(m)]
    assert layers and all(m["moves"] in e2e for m in layers)
