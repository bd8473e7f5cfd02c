"""PyTorch port, serving engine: on mixed-rank traces with nonzero LoRA
weights installed into both engines, the port's ``ServingEngine`` emits
exactly the JAX engine's tokens — padded and bucketed banks, the kernel
("sgmv", plain versions on the CPU) and einsum paths, decode_block 1 and
4, batched same-length prefill, a mid-flight bank rebuild, and free
slots whose position runs past the cache. The JAX side uses
lora_kernel="einsum"; its own suite proves einsum == sgmv there.
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.models import model as JM
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine
from repro_torch import bridge
from repro_torch.models import model as TM
from repro_torch.serving import Request, ServingEngine

ADAPTERS = {"a-r8": 8, "b-r64": 64, "c-r16": 16}


@pytest.fixture(scope="module")
def setup():
    cfg = get_smoke_config("llama-7b-paper")
    jp = JM.init_params(cfg, jax.random.PRNGKey(0))
    tp = bridge.params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                                  device="cpu")
    rng = np.random.default_rng(0)
    L, d = cfg.n_layers, cfg.d_model
    weights = {aid: {t: {"A": (rng.standard_normal((L, d, r)) * 0.2
                               ).astype(np.float32),
                         "B": (rng.standard_normal((L, r, d)) * 0.2
                               ).astype(np.float32)}
                     for t in cfg.lora.targets}
               for aid, r in {**ADAPTERS, "z-r32": 32}.items()}
    return cfg, jp, tp, weights


def _install(eng, weights, ranks, jax_side):
    for aid, r in ranks.items():
        w = weights[aid]
        eng.install_adapter(aid, r, jax.tree.map(jnp.asarray, w) if jax_side
                            else bridge.adapter_weights_from_numpy(
                                w, device="cpu"))


def _run(setup, trace, *, jax_side, max_len=24, max_batch=4, hook=None,
         **kw):
    """Serve ``trace`` [(adapter, prompt, max_new)] to completion; ``hook``
    runs after every step with (engine, step index, jax_side)."""
    cfg, jp, tp, weights = setup
    if jax_side:
        eng = JaxEngine(cfg, jp, dict(ADAPTERS), max_batch=max_batch,
                        max_len=max_len, lora_kernel="einsum", **kw)
        mk = JaxRequest
    else:
        eng = ServingEngine(cfg, tp, dict(ADAPTERS), max_batch=max_batch,
                            max_len=max_len, device="cpu", **kw)
        mk = Request
    _install(eng, weights, ADAPTERS, jax_side)
    now = time.monotonic()
    reqs = [mk(i, aid, prompt, n, arrival=now)
            for i, (aid, prompt, n) in enumerate(trace)]
    for r in reqs:
        eng.submit(r)
    it = 0
    while eng.queue or eng.active:
        eng.step()
        it += 1
        if hook is not None:
            hook(eng, it, jax_side)
        assert it < 200
    return [r.output for r in reqs], eng


def _mixed_trace():
    rng = np.random.default_rng(1)
    ids = list(ADAPTERS)
    return [(ids[i % 3], [int(t) for t in rng.integers(1, 512, 6 + i % 2)],
             4 + i % 4) for i in range(7)]


@pytest.fixture(scope="module")
def jax_mixed(setup):
    return _run(setup, _mixed_trace(), jax_side=True)


@pytest.mark.parametrize("bank_mode", ["padded", "bucketed"])
@pytest.mark.parametrize("decode_block", [1, 4])
@pytest.mark.parametrize("kernel", ["sgmv", "einsum"])
def test_tokens_identical_to_jax_engine(setup, jax_mixed, bank_mode,
                                        decode_block, kernel):
    out, eng = _run(setup, _mixed_trace(), jax_side=False,
                    bank_mode=bank_mode, decode_block=decode_block,
                    lora_kernel=kernel)
    assert out == jax_mixed[0]
    assert eng.tokens_decoded == jax_mixed[1].tokens_decoded
    assert eng.metrics.finished == 7


def test_batched_prefill_admission_matches_jax(setup, jax_mixed):
    """Same-length queued prompts prefill in one call: the port's group
    count equals the JAX engine's, and decode_steps(4) needs >= 2x fewer
    host round-trips than single steps on this short-budget trace."""
    out1, e1 = _run(setup, _mixed_trace(), jax_side=False)
    out4, e4 = _run(setup, _mixed_trace(), jax_side=False, decode_block=4)
    assert e1.prefill_dispatches == jax_mixed[1].prefill_dispatches
    assert e4.decode_dispatches * 2 <= e1.decode_dispatches
    assert out1 == out4


def _rebuild_hook(eng, it, jax_side, setup, at=(2, 3)):
    """Mid-flight rebuilds after steps ``at``: load a new rank bucket, then
    evict an idle adapter. Both engines re-init their banks on a rebuild,
    so the same nonzero weights go back in on both sides."""
    if it == at[0]:
        assert eng.load_adapters({"z-r32": 32})
    elif it == at[1]:
        assert not eng.evict_adapter("b-r64")    # still decoding: refused
        assert eng.evict_adapter("c-r16")        # no request uses it
    else:
        return
    _install(eng, setup[3], eng.adapter_ranks, jax_side)


@pytest.fixture(scope="module")
def jax_rebuild(setup):
    trace = [("a-r8", [3, 1, 4, 1, 5], 6), ("b-r64", [2, 7, 1, 8], 12),
             ("a-r8", [9, 9, 8], 5)]
    return trace, _run(setup, trace, jax_side=True, max_batch=3,
                       hook=lambda e, i, j: _rebuild_hook(e, i, j, setup))


@pytest.mark.parametrize("bank_mode", ["padded", "bucketed"])
@pytest.mark.parametrize("decode_block", [1, 4])
def test_midflight_rebuild_matches_jax(setup, jax_rebuild, bank_mode,
                                       decode_block):
    trace, (want, jeng) = jax_rebuild
    # k-token steps drain sooner: rebuild after steps 1 and 2 there
    at = (2, 3) if decode_block == 1 else (1, 2)
    out, eng = _run(setup, trace, jax_side=False, max_batch=3,
                    bank_mode=bank_mode, decode_block=decode_block,
                    hook=lambda e, i, j: _rebuild_hook(e, i, j, setup, at))
    assert out == want
    assert eng.bank_rebuilds == jeng.bank_rebuilds == 2
    assert sorted(eng.adapter_ranks) == sorted(jeng.adapter_ranks)


@pytest.fixture(scope="module")
def jax_past_cache(setup):
    # a long-prompt request frees its slot early; the short-prompt one
    # decodes on, so the freed slot's position runs past max_len
    trace = [("b-r64", list(range(1, 13)), 2), ("a-r8", [5, 6], 13)]
    return trace, _run(setup, trace, jax_side=True, max_len=16,
                       max_batch=2)


@pytest.mark.parametrize("decode_block", [1, 4])
def test_free_slot_past_max_len_matches_jax(setup, jax_past_cache,
                                            decode_block):
    trace, (want, _) = jax_past_cache
    out, eng = _run(setup, trace, jax_side=False, max_len=16, max_batch=2,
                    decode_block=decode_block)
    assert out == want
    assert int(eng.cache["pos"].max()) > 16     # the trap was exercised


@pytest.fixture(scope="module")
def jax_long_group(setup):
    # two 400-token prompts prefill as one group of 800 tokens: the
    # bucketed path's plan (kernels.tune.block_plan) picks block_t 64
    # there, 16 at decode
    rng = np.random.default_rng(5)
    trace = [(aid, [int(t) for t in rng.integers(1, 512, 400)], 5)
             for aid in ("a-r8", "b-r64")]
    return trace, _run(setup, trace, jax_side=True, max_len=408)


@pytest.mark.parametrize("decode_block", [1, 4])
def test_long_prefill_group_at_the_plan_matches_jax(setup, jax_long_group,
                                                    decode_block,
                                                    monkeypatch):
    from repro_torch.kernels import ops as tops
    trace, (want, _) = jax_long_group
    real, block_ts = tops.sgmv_multibank_blocks, []

    def recorded(*args, **kw):
        block_ts.append(kw["block_t"])
        return real(*args, **kw)

    monkeypatch.setattr(tops, "sgmv_multibank_blocks", recorded)
    out, _ = _run(setup, trace, jax_side=False, max_len=408,
                  bank_mode="bucketed", lora_kernel="sgmv",
                  decode_block=decode_block)
    assert out == want
    assert max(block_ts) == 64 and min(block_ts) == 16


def test_engine_matches_direct_decode(setup):
    """Mirror of test_engine.py: the engine's tokens equal prefill + a
    hand-driven decode loop on the same bank."""
    cfg, _, tp, weights = setup
    eng = ServingEngine(cfg, tp, dict(ADAPTERS), max_batch=4, max_len=48,
                        device="cpu")
    _install(eng, weights, ADAPTERS, False)
    prompt = list(range(1, 9))
    idx = eng.lora_bank.lora_idx(torch.tensor([0], dtype=torch.int32))
    logits, cache = TM.prefill(cfg, tp, torch.tensor([prompt]), bank=eng.bank,
                               lora_idx=idx, cache_len=48,
                               cache_dtype=torch.float32, lora_kernel="sgmv")
    want = [int(logits[0].argmax())]
    for _ in range(4):
        l2, cache = TM.decode_step(cfg, tp, cache, torch.tensor([want[-1]]),
                                   bank=eng.bank, lora_idx=idx,
                                   lora_kernel="sgmv")
        want.append(int(l2[0].argmax()))
    req = Request(0, "a-r8", prompt, 5, arrival=time.monotonic())
    eng.submit(req)
    summ = eng.run_until_drained()
    assert req.output == want
    assert summ["finished"] == 1 and summ["p95_ttft"] > 0


def test_cobatching_preserves_outputs(setup):
    prompt_a, prompt_b = list(range(1, 9)), list(range(3, 14))
    solo, _ = _run(setup, [("a-r8", prompt_a, 5)], jax_side=False,
                   max_len=48)
    both, _ = _run(setup, [("a-r8", prompt_a, 5), ("b-r64", prompt_b, 5)],
                   jax_side=False, max_len=48)
    assert both[0] == solo[0]


def test_bucketed_rebalance_midflight_and_padding(setup):
    """Mirror of test_engine_bucketed_rebalance_midflight and
    test_bank_max_rank_padding."""
    cfg, _, tp, _ = setup
    eng = ServingEngine(cfg, tp, {"a-r8": 8, "b-r16": 16}, max_batch=2,
                        max_len=24, bank_mode="bucketed", device="cpu")
    req = Request(0, "b-r16", list(range(1, 7)), 4)
    eng.submit(req)
    eng.step()
    assert eng.active == 1
    eng.load_adapters({"z-r64": 64})
    assert eng.lora_bank.bucket_ranks == (8, 16, 64)
    assert isinstance(eng.bank, tuple)
    assert not eng.evict_adapter("b-r16")       # in flight -> refused
    eng.run_until_drained()
    assert len(req.output) >= 4
    assert eng.evict_adapter("b-r16")
    assert eng.lora_bank.bucket_ranks == (8, 64)
    padded = ServingEngine(cfg, tp, dict(ADAPTERS), max_len=8, device="cpu")
    assert padded.max_rank == 64 and padded.bank["q"]["A"].shape[-1] == 64


def test_exhausted_budget_finishes_and_cancel(setup):
    """A request admitted with no decode budget left (max_new_tokens=1)
    still finishes under decode_block > 1; cancel frees queue and slot."""
    cfg, _, tp, _ = setup
    outs = []
    for k in (1, 8):
        eng = ServingEngine(cfg, tp, dict(ADAPTERS), max_batch=2,
                            max_len=40, decode_block=k, device="cpu")
        req = Request(0, "a-r8", [1, 2, 3], 1)
        eng.submit(req)
        eng.run_until_drained(max_iters=50)
        assert eng.active == 0 and not eng.queue
        outs.append(req.output)
    assert outs[0] == outs[1]
    eng = ServingEngine(cfg, tp, dict(ADAPTERS), max_batch=1, max_len=40,
                        device="cpu")
    a, b = Request(0, "a-r8", [1, 2], 9), Request(1, "c-r16", [3, 4], 9)
    eng.submit(a)
    eng.submit(b)
    eng.step()
    assert eng.cancel(1) is b and eng.cancel(0) is a
    assert eng.active == 0 and not eng.queue and eng.cancel(0) is None
    with pytest.raises(KeyError):
        eng.submit(Request(2, "nope", [1], 1))


def test_tracer_spans_carry_batch_shape(setup):
    class Rec:
        def __init__(self):
            self.spans = []

        def record(self, name, t0, t1, **kw):
            self.spans.append((name, kw["attrs"]))

    cfg, _, tp, _ = setup
    rec = Rec()
    eng = ServingEngine(cfg, tp, dict(ADAPTERS), max_batch=4, max_len=24,
                        bank_mode="bucketed", decode_block=2, tracer=rec,
                        device="cpu")
    for i, aid in enumerate(["a-r8", "b-r64"]):
        eng.submit(Request(i, aid, [1, 2, 3], 3))
    eng.run_until_drained()
    pre = [a for n, a in rec.spans if n == "prefill"]
    dec = [a for n, a in rec.spans if n == "decode"]
    assert pre == [{"max_rank": 64, "bank_mode": "bucketed",
                    "buckets": {8: 3, 64: 3}, "tokens": 6, "batch": 2}]
    assert dec[0]["steps"] == 2 and dec[0]["buckets"] == {8: 1, 64: 1}


def test_engine_without_card_raises_unless_cpu_is_asked(setup):
    if torch.cuda.is_available():
        pytest.skip("a card is present: device='cuda' is valid here")
    cfg, _, tp, _ = setup
    with pytest.raises(RuntimeError, match="cuda"):
        ServingEngine(cfg, tp, dict(ADAPTERS))
    with pytest.raises(RuntimeError, match="cuda"):
        TM.init_params(cfg, 0)


def test_launcher_serves_on_cpu(monkeypatch, capsys):
    """The launcher end to end at the smoke size on the CPU, profiled."""
    from repro_torch.launch import serve
    monkeypatch.setattr("sys.argv", [
        "serve", "--config", "smoke", "--device", "cpu", "--requests", "3",
        "--prompt-lens", "4,6", "--max-new", "3", "--bank-mode", "bucketed",
        "--decode-block", "2", "--dtype", "float32", "--profile"])
    serve.main()
    out = capsys.readouterr().out
    assert "finished=3/3" in out and "bank_mode=bucketed" in out
    assert "on the CPU: no device time" in out


HOST_PARTS = {"attention", "lora", "ffn", "logits"}


def _serve(setup, k, **kw):
    """Four requests of two prompt lengths through three slots, the
    fourth admitted mid-flight; returns the engine and its steps."""
    cfg, _, tp, _ = setup
    eng = ServingEngine(cfg, tp, dict(ADAPTERS), max_batch=3, max_len=24,
                        bank_mode="bucketed", decode_block=k, device="cpu",
                        **kw)
    for i, (aid, n) in enumerate([("a-r8", 3), ("b-r64", 3), ("c-r16", 5),
                                  ("a-r8", 5)]):
        eng.submit(Request(i, aid, list(range(1, n + 1)), 3))
    steps = 0
    while eng.queue or eng.active:
        eng.step()
        steps += 1
    return eng, steps


@pytest.fixture(scope="module", params=[1, 4], ids=["k1", "k4"])
def served(setup, request):
    """The same requests at decode block k, served without a tracer
    ("quiet") and with one ("traced"): (engine, steps, clock reads, the
    part slot as each model step found it, tracer) for each."""
    from repro_torch.obs import Tracer
    from repro_torch.obs import host as obs_host
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        step = TM.decode_step
        seen = []

        def watched(*a, **kw):
            seen.append(obs_host.PARTS)
            return step(*a, **kw)
        mp.setattr(TM, "decode_step", watched)
        for name, tracer in (("quiet", None), ("traced", Tracer())):
            reads = []

            def clock():
                reads.append(1)
                return time.monotonic()
            seen.clear()
            eng, steps = _serve(setup, request.param, clock=clock,
                                tracer=tracer)
            out[name] = (eng, steps, len(reads), list(seen), tracer)
    return out


def test_host_spans_telescope_to_the_iteration_spans(served, setup):
    """Each decode span is exactly ``decode.launch`` then ``decode.sync``,
    each prefill span ``prefill.launch``, ``.sync`` and ``.merge``;
    ``finish`` follows each decode span, ``admit`` holds its prefill
    groups, and a launch's part self times sum to no more than it."""
    tracer = served["traced"][4]
    named = {}
    for s in tracer.spans:
        named.setdefault(s.name, []).append(s)
    assert {s.cat for s in named["decode"] + named["prefill"]} == \
        {"iteration"}
    for it, kids in (("decode", ("launch", "sync")),
                     ("prefill", ("launch", "sync", "merge"))):
        chains = [named[f"{it}.{c}"] for c in kids]
        assert all(len(c) == len(named[it]) for c in chains)
        for parent, *chain in zip(named[it], *chains):
            assert chain[0].start == parent.start
            assert all(a.end == b.start for a, b in zip(chain, chain[1:]))
            assert chain[-1].end == parent.end
            assert all(c.cat == "host" and c.track == "server:0"
                       for c in chain)
    for d, f in zip(named["decode"], named["finish"]):
        assert f.start == d.end <= f.end
    assert len(named["finish"]) == len(named["decode"])
    assert len(named["admit"]) == 2
    for p in named["prefill"]:
        assert any(a.start <= p.start and p.end <= a.end
                   for a in named["admit"])
    L = setup[0].n_layers
    for launch in named["decode.launch"] + named["prefill.launch"]:
        host_s, calls = launch.attrs["host_s"], launch.attrs["calls"]
        assert set(host_s) == set(calls) == HOST_PARTS
        assert all(v >= 0 for v in host_s.values())
        assert sum(host_s.values()) <= launch.end - launch.start
    for launch, d in zip(named["decode.launch"], named["decode"]):
        n = d.attrs["steps"]
        # per step: each layer's attention, FFN and LoRA binding, the four
        # targets' hooks; the head and the argmax
        assert launch.attrs["calls"] == {"attention": L * n, "ffn": L * n,
                                         "lora": 5 * L * n,
                                         "logits": 2 * n}


def test_clock_reads_without_a_tracer_are_the_parents(served):
    """Without a tracer the engine reads its clock as it did before the
    host spans: once a step, twice a prefill group and twice a decode
    dispatch; and the model never finds a part slot. A tracer adds
    reads and fills the slot inside each launch only."""
    from repro_torch.obs import host as obs_host
    eng, steps, reads, seen, _ = served["quiet"]
    assert reads == steps + 2 * eng.prefill_dispatches + \
        2 * eng.decode_dispatches
    assert seen and all(p is None for p in seen)
    eng, steps, traced_reads, seen, _ = served["traced"]
    assert traced_reads > reads
    assert seen and all(p is not None for p in seen)
    assert obs_host.PARTS is None


def _layout_run(setup, k, bank_mode):
    """``_serve``'s requests (two admit passes) with nonzero adapters and
    a bank rebuild after the first step, traced. Returns the engine, the
    tokens, the spans and the span count at the rebuild."""
    from repro_torch.obs import Tracer
    cfg, _, tp, weights = setup
    tracer = Tracer()
    eng = ServingEngine(cfg, tp, dict(ADAPTERS), max_batch=3, max_len=24,
                        bank_mode=bank_mode, decode_block=k, tracer=tracer,
                        device="cpu")
    _install(eng, weights, ADAPTERS, False)
    reqs = [Request(i, aid, list(range(1, n + 1)), 3)
            for i, (aid, n) in enumerate([("a-r8", 3), ("b-r64", 3),
                                          ("c-r16", 5), ("a-r8", 5)])]
    for r in reqs:
        eng.submit(r)
    eng.step()
    assert eng.load_adapters({"z-r32": 32})
    _install(eng, weights, eng.adapter_ranks, False)
    rebuilt_at = len(tracer.spans)
    eng.run_until_drained()
    return eng, [r.output for r in reqs], tracer.spans, rebuilt_at


@pytest.mark.parametrize("bank_mode", ["padded", "bucketed"])
@pytest.mark.parametrize("decode_block", [1, 4])
def test_layout_plan_builds_once_a_batch(setup, bank_mode, decode_block,
                                         monkeypatch):
    """The engine's ``LayoutPlan``s: the tokens of the per-call layout
    (the plan taken away); one layout for each prefill group, and one for
    the first decode launch after an admit pass or a bank rebuild, as the
    launches' ``lora_layouts`` and ``lora_layout_builds`` count them."""
    eng, out, spans, rebuilt_at = _layout_run(setup, decode_block,
                                              bank_mode)
    fresh = False
    for i, s in enumerate(spans):
        fresh = fresh or i == rebuilt_at or s.name == "admit"
        if s.name == "prefill.launch":
            assert s.attrs["lora_layouts"] == 1
        elif s.name == "decode.launch":
            assert s.attrs["lora_layouts"] == int(fresh), i
            fresh = False
    admits = sum(s.name == "admit" for s in spans)
    # k = 1: the rebuild's plan runs the next decode; k = 4: the first
    # three requests finish in the first block, and the next step's admit
    # pass replaces it before any decode
    followed = [s.name for s in spans[rebuilt_at:]
                if s.name in ("admit", "decode.launch")][0] == "decode.launch"
    assert followed == (decode_block == 1) and admits == 2
    assert eng.lora_layout_builds == admits + eng.prefill_dispatches + \
        followed == sum(s.attrs.get("lora_layouts", 0) for s in spans)

    from repro_torch.serving.engine import ServingEngine as Engine
    monkeypatch.setattr(Engine, "_plan",
                        lambda self, a: self.lora_bank.lora_idx(a))
    plain, plain_out, plain_spans, _ = _layout_run(setup, decode_block,
                                                   bank_mode)
    assert plain_out == out
    assert plain.lora_layout_builds == 0
    assert all(s.attrs["lora_layouts"] == 0 for s in plain_spans
               if s.name.endswith(".launch"))
