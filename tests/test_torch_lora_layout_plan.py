"""PyTorch port, the LoRA hook's segment layout built once a batch
(``lora.batched.LayoutPlan``), checked without a card and without JAX.

* ``make_lora_cb`` given its index tensor in a ``LayoutPlan`` gives the
  delta of the plain tensor, which lays the tokens out in every call,
  bit for bit: padded and bucketed banks, a decode batch (S = 1, 64 rows,
  most of them empty slots left on adapter row 0) and prefill groups of 1
  and 3 rows (S > 1), fp32 and bf16, ``block_t`` from the plan and
  pinned. The kernels (their plain versions here) get the same layout
  tensors either way.
* The plan builds each layout once over every target and repeated calls,
  and a new one when the token count or ``block_t`` changes; the einsum
  forms take the tensor inside and build none.
"""
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ops
from repro_torch.lora.bank import build_bank
from repro_torch.lora.batched import LayoutPlan, make_lora_cb
from repro_torch.models.model import bank_layer

RANKS = {"a-r8": 8, "b-r16": 16, "c-r64": 64}
TARGETS = ("q", "k", "v", "o")
# (rows, S, the rows' global adapters): a decode batch of 64 slots, most
# of them empty (a free slot keeps adapter row 0), and prefill groups
SHAPES = {
    "decode64": (64, 1, [2, 1, 0, 2, 1] + [0] * 59),
    "prefill1": (1, 9, [2]),
    "prefill3": (3, 7, [1, 2, 1]),
}


def _bank(mode, dtype):
    cfg = get_smoke_config("llama-7b-paper")
    bank = build_bank(cfg, RANKS, 3, mode=mode, dtype=dtype, device="cpu")
    g = torch.Generator().manual_seed(11)
    L, d = cfg.n_layers, cfg.d_model
    for aid, r in RANKS.items():
        w = {t: {"A": torch.randn((L, d, r), generator=g) * 0.2,
                 "B": torch.randn((L, r, d), generator=g) * 0.2}
             for t in TARGETS}
        bank.set_adapter(aid, w)
    return cfg, bank


class KernelArgs:
    """While entered, records the arguments of every call of B1 and B2
    (their plain versions on CPU tensors) and forwards it."""

    NAMES = ("sgmv_fused_blocks", "sgmv_multibank_blocks")

    def __init__(self, monkeypatch):
        self.calls = []
        for name in self.NAMES:
            real = getattr(ops, name)

            def call(*a, _real=real, **kw):
                self.calls.append((a, kw))
                return _real(*a, **kw)
            monkeypatch.setattr(ops, name, call)


def _tensors(a):
    if isinstance(a, torch.Tensor):
        return [a]
    if isinstance(a, (tuple, list)):
        return [t for v in a for t in _tensors(v)]
    if isinstance(a, dict):
        return [t for k in sorted(a) for t in _tensors(a[k])]
    return []


@pytest.mark.parametrize("mode", ["padded", "bucketed"])
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("block_t", [None, 4], ids=["planned", "pinned4"])
def test_plan_delta_equals_the_per_call_delta(mode, shape, dtype, block_t,
                                              monkeypatch):
    cfg, bank = _bank(mode, dtype)
    rows, S, adapters = SHAPES[shape]
    idx = bank.lora_idx(torch.tensor(adapters, dtype=torch.int32))
    g = torch.Generator().manual_seed(rows * 31 + S)
    xs = {t: (torch.randn((rows, S, cfg.d_model), generator=g)
              ).to(dtype) for t in TARGETS}
    built = []
    plan = LayoutPlan(idx, lambda: built.append(1))
    outs, args = {}, {}
    for name, lora_idx in (("plain", idx), ("plan", plan)):
        rec = KernelArgs(monkeypatch)
        cb = make_lora_cb(bank_layer(bank.data, 1), lora_idx,
                          kernel="sgmv", block_t=block_t)
        # every target, then q again: later calls find the layout built
        outs[name] = [cb(t, xs[t]) for t in TARGETS + ("q",)]
        args[name] = rec.calls
        monkeypatch.undo()
    for got, want in zip(outs["plan"], outs["plain"]):
        assert got.dtype == dtype
        assert torch.equal(got, want)
    assert len(args["plan"]) == len(args["plain"]) == len(TARGETS) + 1
    for (a1, k1), (a2, k2) in zip(args["plan"], args["plain"]):
        assert sorted(k1) == sorted(k2)
        assert k1["block_t"] == k2["block_t"]
        t1, t2 = _tensors((a1, k1)), _tensors((a2, k2))
        assert len(t1) == len(t2)
        assert all(torch.equal(u, v) for u, v in zip(t1, t2))
    assert len(built) == 1
    if block_t is None and mode == "bucketed":
        banks = [(bk["q"]["A"][1], bk["q"]["B"][1]) for bk in bank.data]
        block_t = ops.plan_block_t(xs["q"].flatten(0, 1), banks)
    assert args["plan"][0][1]["block_t"] == (block_t or 16)


@pytest.mark.parametrize("mode", ["padded", "bucketed"])
def test_plan_builds_each_layout_once(mode):
    cfg, bank = _bank(mode, torch.float32)
    idx = bank.lora_idx(torch.tensor([1, 0, 2], dtype=torch.int32))
    built = []
    plan = LayoutPlan(idx, lambda: built.append(1))
    x = {S: torch.randn((3, S, cfg.d_model)) for S in (1, 2)}
    cbs = {bt: make_lora_cb(bank_layer(bank.data, 0), plan, kernel="sgmv",
                            block_t=bt) for bt in (None, 8)}
    for S, bt, want in ((1, None, 1), (1, None, 1), (2, None, 2),
                        (2, 8, 3), (1, 8, 4), (2, None, 4), (1, 8, 4)):
        for t in TARGETS:
            cbs[bt](t, x[S])
        assert len(built) == want, (S, bt)
    # the einsum forms take the tensor inside the plan, bit for bit
    ein = make_lora_cb(bank_layer(bank.data, 0), plan, kernel="einsum")
    plain = make_lora_cb(bank_layer(bank.data, 0), idx, kernel="einsum")
    for t in TARGETS:
        assert torch.equal(ein(t, x[2]), plain(t, x[2]))
    assert len(built) == 4
