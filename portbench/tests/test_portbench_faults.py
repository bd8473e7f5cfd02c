"""A run of each cell, at the tiny sizes on the CPU, past the harness's
look for a card: sound, its check passes; with the timed path broken
underneath, ``correct`` comes out false. The faults a served model's cell
can have: a token altered where it is produced, a decode step that
returns its state unchanged, half of the batch left out. (One card: no
exchange between chips to leave out.)"""
import pytest
import torch

from portbench import check, harness
from portbench.tests.tiny import tiny_cell

from repro_torch.models import model as M
from repro_torch.serving.engine import ServingEngine

CELLS = ["qwen2.5-32b-l32.batch", "deepseek-v2-lite-16b.batch"]


def altered_token(monkeypatch):
    fn = ServingEngine._decode_fn

    def wrong(self, tokens):
        return (fn(self, tokens) + 1) % self.cfg.vocab_size
    monkeypatch.setattr(ServingEngine, "_decode_fn", wrong)


def state_unchanged(monkeypatch):
    step = M.decode_step

    def stale(cfg, params, cache, tokens, **kw):
        saved = {k: v.clone() for k, v in cache.items()}
        logits, _ = step(cfg, params, cache, tokens, **kw)
        for k, v in cache.items():
            v.copy_(saved[k])
        return logits, cache
    monkeypatch.setattr(M, "decode_step", stale)


def half_batch(monkeypatch):
    step = M.decode_step

    def half(cfg, params, cache, tokens, **kw):
        logits, new = step(cfg, params, cache, tokens, **kw)
        h = logits.shape[0] // 2
        logits[h:] = logits[:1]
        return logits, new
    monkeypatch.setattr(M, "decode_step", half)


def run(workload):
    cell = tiny_cell(workload)
    out = harness.run_cell(cell, 2 ** 31 + 11, 0.6, False, "cpu")
    return check.correct(out["compared"], cell.engine["check"]["statistic"])


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    assert run(workload)


@pytest.mark.parametrize("fault", [altered_token, state_unchanged,
                                   half_batch])
@pytest.mark.parametrize("workload", CELLS)
def test_fault_makes_it_incorrect(workload, fault, monkeypatch):
    fault(monkeypatch)
    with torch.no_grad():
        assert not run(workload)
