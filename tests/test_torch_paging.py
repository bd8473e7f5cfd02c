"""PyTorch port, unified paging (ROADMAP queue A item 6): the engine's
``page_pool`` hooks against the JAX engine's, and ``EngineBackend
(page_pool_factory=...)`` under the cluster facade.

``serving/paging.py`` is a copy of the JAX package's; its syntax tree is
held against the original in ``tests/test_torch_port_rules.py``. Here the
same trace, with the same nonzero adapter weights, runs through the port's
engine and the JAX engine, each with its own package's pool of the same
size: the tokens are equal and ``pages_by_kind()`` is equal after every
step (the hybrid family pages one layer of adapter bytes), and a
cancelled request frees its pages in both. The pool keeps accounts only:
the tokens equal a run without it.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_jax_side import nonzero_weights
from repro.configs import get_smoke_config
from repro.models import model as JM
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine
from repro.serving.paging import UnifiedPagePool as JaxPool
from repro_torch import bridge
from repro_torch.launch.serve import (SeededWeightsBackend, adapter_weights,
                                      build_cluster_trace, cluster_adapters,
                                      drive)
from repro_torch.lora.adapter import Adapter
from repro_torch.models import model as TM
from repro_torch.serving import (LoRAServeCluster, Request, ServingEngine,
                                 UnifiedPagePool)

# the dense engine and the hybrid one, whose adapters page one layer
ARCHS = ["llama-7b-paper", "zamba2-7b"]
ADAPTERS = {"a-r8": 8, "b-r32": 32, "c-r16": 16}
# small pages, so prompts span several and decode grows them
POOL = dict(n_pages=96, page_tokens=4, page_bytes=20_000)


@functools.lru_cache(maxsize=None)
def _setup(arch):
    cfg = get_smoke_config(arch)
    jp = JM.init_params(cfg, jax.random.PRNGKey(0))
    tp = bridge.params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                                  device="cpu")
    return cfg, jp, tp, nonzero_weights(cfg, ADAPTERS, 5)


def _run(arch, *, jax_side, pool=True, cancel=None):
    """Serve 6 requests over 3 adapters on 4 slots; with ``cancel``, that
    request is cancelled after the first step. Returns (tokens, the
    pool's pages by kind after each step, the pool)."""
    cfg, jp, tp, weights = _setup(arch)
    if jax_side:
        pp = JaxPool(**POOL) if pool else None
        eng = JaxEngine(cfg, jp, dict(ADAPTERS), max_batch=4, max_len=20,
                        lora_kernel="einsum", page_pool=pp)
        mk, conv = JaxRequest, lambda w: jax.tree.map(jnp.asarray, w)
    else:
        pp = UnifiedPagePool(**POOL) if pool else None
        eng = ServingEngine(cfg, tp, dict(ADAPTERS), max_batch=4, max_len=20,
                            bank_mode="bucketed", device="cpu", page_pool=pp)
        mk, conv = Request, lambda w: bridge.adapter_weights_from_numpy(
            w, device="cpu")
    for aid, r in ADAPTERS.items():
        eng.install_adapter(aid, r, conv(weights[aid]))
    rng = np.random.default_rng(2)
    ids = sorted(ADAPTERS)
    reqs = [mk(i, ids[i % 3], [int(t) for t in rng.integers(
        1, cfg.vocab_size, 5 + 3 * (i % 2))], 4 + i % 3, arrival=0.0)
        for i in range(6)]
    for r in reqs:
        eng.submit(r)
    pages = []
    while eng.queue or eng.active:
        eng.step()
        if cancel is not None and not pages:
            assert eng.cancel(cancel) is not None
        if pp is not None:
            pages.append(pp.pages_by_kind())
            assert pp.check_invariant()
    return [r.output for r in reqs], pages, pp


@pytest.mark.parametrize("arch", ARCHS)
def test_page_accounts_match_the_jax_engine(arch):
    toks, pages, pool = _run(arch, jax_side=False)
    jtoks, jpages, jpool = _run(arch, jax_side=True)
    assert toks == jtoks
    assert pages == jpages
    assert any(p["kv"] > 0 and p["adapter"] > 0 for p in pages)
    # drained: no KV page left, the adapters resident and unpinned
    assert pages[-1]["kv"] == 0 and pages[-1] == jpages[-1]
    assert pool.adapter_page_ins == jpool.adapter_page_ins == 3
    assert not any(a.pinned for a in pool._allocs.values())
    # the pool only keeps accounts
    assert _run(arch, jax_side=False, pool=False)[0] == toks


def test_hybrid_pages_one_layer_of_adapter_bytes():
    cfg = _setup("zamba2-7b")[0]
    _, _, pool = _run("zamba2-7b", jax_side=False)
    want = sum(-(-max(1, Adapter(a, r).nbytes(cfg) // cfg.n_layers)
                 // POOL["page_bytes"]) for a, r in ADAPTERS.items())
    assert pool.pages_by_kind()["adapter"] == want


@pytest.mark.parametrize("arch", ARCHS)
def test_cancel_frees_pages_as_the_jax_engine(arch):
    toks, pages, _ = _run(arch, jax_side=False, cancel=1)
    jtoks, jpages, _ = _run(arch, jax_side=True, cancel=1)
    assert toks == jtoks and pages == jpages
    assert pages[-1]["kv"] == 0


def test_engine_backend_with_a_page_pool_drains():
    """``EngineBackend(page_pool_factory=...)`` at zamba2: one pool per
    engine, the cluster facade drains, every pool's invariant holds with
    no KV page left, and the tokens equal the same run without pools."""
    cfg = get_smoke_config("zamba2-7b")
    params = TM.init_params(cfg, 0, device="cpu")
    adapters = cluster_adapters(4)
    weights = adapter_weights(cfg, {a.adapter_id: a.rank for a in adapters},
                              dtype=params.embed.dtype, device="cpu", seed=0)
    out = []
    for factory in (None, lambda: UnifiedPagePool(n_pages=4096,
                                                  page_tokens=8,
                                                  page_bytes=50_000)):
        backend = SeededWeightsBackend(
            cfg, params, 2, weights=weights, max_batch=4, max_len=32,
            bank_mode="bucketed", decode_block=2, device="cpu",
            page_pool_factory=factory)
        cluster = LoRAServeCluster(backend, adapters, rebalance_period=0.5)
        trace = build_cluster_trace(adapters, cfg, 8, (6, 9), 4, 1.0, 3)
        report = drive(cluster, trace, dt=0.05)
        assert report.completed() == len(trace)
        engines = [e for e in backend.engines if e is not None]
        pools = [e.page_pool for e in engines]
        if factory is None:
            assert pools == [None] * len(engines)
        else:
            assert len({id(p) for p in pools}) == len(engines) == 2
            for p in pools:
                assert p.check_invariant()
                assert p.pages_by_kind()["kv"] == 0
                assert p.pages_by_kind()["adapter"] > 0
        out.append({r.req_id: list(r.output) for r in trace})
    assert out[0] == out[1]
