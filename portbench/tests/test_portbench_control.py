"""The check's control: the reference on float8 weights, put in the
program's place, has to fail the limit the program passes. On the CPU at
the tiny sizes; on the card at each cell's own size, three seeds (about
eight minutes; the benchmark's own runs never run it)."""
import json

import pytest

from portbench import harness
from portbench.tests.tiny import tiny_cell

CELLS = [w["name"] for w in json.loads(
    (harness.ROOT / "BENCHMARK.json").read_text())["workloads"]]


def readings(cell, seed, seconds, device):
    out = harness.run_cell(cell, seed, seconds, False, device, control=True)
    stat = cell.engine["check"]["statistic"]
    c = out["compared"]
    return c[stat]["value"], c["control_" + stat]["value"], \
        c[stat]["limit"]


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_where_the_program_passes(workload):
    # float8 flips some tenths of a tiny model's tokens: a sample of a few
    # hundred holds some whatever the CPU's speed
    cell = tiny_cell(workload)
    cell.engine["check"]["sample_tokens"] = 300
    mine, theirs, limit = readings(cell, 5, 2.0, "cpu")
    assert mine <= limit < theirs


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_on_the_card(workload, card):
    cell = harness.load_cell(workload)
    for seed in (2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3):
        mine, theirs, limit = readings(cell, seed, 20.0, card)
        assert mine <= limit < theirs, (seed, mine, theirs)
