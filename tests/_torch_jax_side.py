"""Helpers shared by the PyTorch port's serving and model tests (imported
by ``test_torch_cluster.py``, ``test_torch_obs.py``, ``test_torch_server.py``,
``test_torch_sim.py``, ``test_torch_moe.py``, ``test_torch_mla.py``,
``test_torch_configs.py`` and the recurrent, paging and merge tests): the
JAX side of a parity run with the same seeded adapter weights as the
port's, nonzero adapter weights at every target's own widths, and a plain
form of two packages' results for comparing them."""
import dataclasses
import enum
import math
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_smoke_config
from repro.lora.adapter import _target_in_dim, _target_out_dim
from repro.models import model as JM
from repro.serving import EngineBackend as JEngineBackend
from repro_torch import bridge
from repro_torch.launch.serve import registered_weights


class JaxSeededBackend(JEngineBackend):
    """The JAX ``EngineBackend`` with the weights of every hosted adapter
    installed again after each engine build or bank rebuild (a rebuilt
    bank's B is zero), as ``launch.serve.SeededWeightsBackend`` does on
    the port; an adapter just read from a peer keeps the peer's rows."""

    def __init__(self, *args, weights, **kw):
        self.weights = weights
        self._installed = weakref.WeakKeyDictionary()
        super().__init__(*args, **kw)

    def _reinstall(self, sid, remote=None):
        eng = self.engines[sid]
        if eng is None or self._installed.get(eng) == eng.bank_rebuilds:
            return
        for aid, r in eng.adapter_ranks.items():
            if aid != remote or aid not in self._remote[sid]:
                eng.install_adapter(aid, r, self.weights[aid])
        self._installed[eng] = eng.bank_rebuilds

    def load_adapters(self, sid, ranks):
        super().load_adapters(sid, ranks)
        self._reinstall(sid)

    def load_adapter_remote(self, sid, aid, rank, peer):
        super().load_adapter_remote(sid, aid, rank, peer)
        self._reinstall(sid, remote=aid)

    def evict_adapter(self, sid, aid):
        out = super().evict_adapter(sid, aid)
        self._reinstall(sid)
        return out


class JaxWeights(dict):
    """Adapter weights for ``JaxSeededBackend``: an adapter id missing
    (one registered at run time, named ``...-r{rank}``) gets the port's
    ``registered_weights`` (fp32, CPU, the backends' seed 0) as JAX
    arrays, the weights the port's ``SeededWeightsBackend`` makes for
    it."""

    def __init__(self, cfg, weights, seed=0):
        super().__init__(weights)
        self.cfg, self.seed = cfg, seed

    def __missing__(self, aid):
        rank = int(aid.rsplit("-r", 1)[1])
        w = registered_weights(self.cfg, aid, rank, dtype=torch.float32,
                               device="cpu", seed=self.seed)
        self[aid] = {t: {k: jnp.asarray(v.numpy()) for k, v in d.items()}
                     for t, d in w.items()}
        return self[aid]


def seeded_setup(ranks):
    """The reduced llama-7b-paper: JAX params (PRNGKey 0) and the same
    bridged to torch; nonzero adapter weights for ``ranks``
    ({adapter: rank}) from a numpy seed, on both sides. Returns (cfg,
    JAX params, torch params, JAX weights, torch weights)."""
    cfg = get_smoke_config("llama-7b-paper")
    jp = JM.init_params(cfg, jax.random.PRNGKey(0))
    tp = bridge.params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                                  device="cpu")
    rng = np.random.default_rng(0)
    L, d = cfg.n_layers, cfg.d_model
    w = {aid: {t: {"A": (rng.standard_normal((L, d, r)) * 0.2
                         ).astype(np.float32),
                   "B": (rng.standard_normal((L, r, d)) * 0.2
                         ).astype(np.float32)}
               for t in cfg.lora.targets}
         for aid, r in ranks.items()}
    jw = JaxWeights(cfg, {aid: jax.tree.map(jnp.asarray, x)
                          for aid, x in w.items()})
    tw = {aid: bridge.adapter_weights_from_numpy(
        x, device="cpu") for aid, x in w.items()}
    return cfg, jp, tp, jw, tw


def nonzero_weights(cfg, ranks, seed, scale=0.2):
    """Adapter weights ``{adapter: {target: {"A": (L, d_in, r), "B": (L, r,
    d_out)}}}`` as fp32 numpy from a seed, every entry nonzero (a fresh
    bank's B is zero, ROADMAP C1), at each target's widths (MLA's q, k/v
    and o differ from d_model; so do GQA's k and v). L is the serving
    bank's: one layer for the hybrid family (the JAX engine's
    ``_rebuild_bank``), else ``n_layers``."""
    rng = np.random.default_rng(seed)
    L = 1 if cfg.family == "hybrid" else cfg.n_layers
    return {aid: {t: {"A": (rng.standard_normal(
                          (L, _target_in_dim(cfg, t), r)) * scale
                          ).astype(np.float32),
                      "B": (rng.standard_normal(
                          (L, r, _target_out_dim(cfg, t))) * scale
                          ).astype(np.float32)}
                  for t in cfg.lora.targets}
            for aid, r in ranks.items()}


def plain(obj):
    """``obj`` with dataclasses as dicts of their fields, enums as their
    values, tuples as lists and NaN as the string ``"nan"``: the two
    packages' results (whose classes differ) compare equal when their
    contents do."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: plain(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, enum.Enum):
        return plain(obj.value)
    if isinstance(obj, dict):
        return {plain(k): plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [plain(v) for v in obj]
    if isinstance(obj, (set, frozenset)):
        return sorted(plain(v) for v in obj)
    if isinstance(obj, float) and math.isnan(obj):
        return "nan"
    return obj
