"""Single-server serving engine of the PyTorch port: slot-based continuous
batching with heterogeneous LoRA adapters applied through the batched
bank (the counterpart of the JAX package's ``serving/engine.py``).

Prefill admission is batched: queued prompts of the SAME length are
packed into one prefill call and their cache rows scattered into slots
in one merge. Decode runs one step for the whole slot batch;
``decode_steps(k)`` runs k of them on the device with on-device argmax
and per-slot remaining-token bookkeeping, so decode costs one host sync
per k tokens. Each slot row carries its own cache position; free slots
drop their writes. The slots' adapter indices go to the model in a
``lora.batched.LayoutPlan``, made anew at each admit pass and bank
rebuild, and each prefill group's in one of its own: the SGMV segment
layout is built once for the batch, in its first LoRA hook call, and
``lora_layout_builds`` counts the layouts built.

The engine is placement-aware: its bank holds only the adapters placed
onto this server, padded to that subset's max rank. ``load_adapters`` /
``evict_adapter`` rebuild the bank mid-flight, remapping the adapter
indices of co-batched slots. ``bank_mode`` selects the layout
(``"padded"`` or ``"bucketed"``); both give the same tokens.

``lora_kernel`` defaults to ``"sgmv"``: the hand-written kernels B1
(padded) and B2 (bucketed), or their plain versions when the engine runs
on the CPU. ``"einsum"`` selects the gather-einsum path.

``mesh`` (a ``launch.mesh.TensorParallel``, from ``make_engine_mesh``)
turns on the mesh-sharded mode over (dp, tp): this process is one rank
of an SPMD group, every rank runs the same engine loop on the same
requests, and the engine keeps the rank's slice of the weights, the
cache and the co-sharded bank (``serving.sharding``), for every family;
``params`` may be the rank's slice already (``models.model.init_params(
tp=...)``). The bank is sharded again after every rebuild and install.
Bank kernels at tp > 1: B3a/B3b (padded) and B4a/B4b (bucketed). Tokens
are identical on every rank (the hidden state after each all-reduce
is), and match the single-device engine's by token, not by bit: the
all-reduce reorders the d-sums. The MoE family's prefill runs the
reference's expert-parallel path, whose capacity drops tokens, so its
tokens are the JAX mesh engine's rather than one device's.

At dp > 1 the slot batch splits over the dp replicas where dp divides
``max_batch`` (``sharding.slot_rows``; otherwise every replica runs
every slot): a replica's cache holds its max_batch / dp slot rows and
its decode steps run them, and one all-gather of the emitted tokens
over the dp group a decode dispatch (one per k-block of
``decode_steps``) gives every replica's scheduler every token, so the
slots, queues, banks and page accounts stay the same on every rank.
Every replica runs a prefill group's whole prefill and keeps its own
slots' rows of the cache: the MoE's expert-parallel path then splits the
group over dp as the JAX mesh's "data" axis does (``models.ffn``), and
its capacity drops the reference's tokens.

The VLM and audio families take a frontend at prefill: as the JAX engine
does, a group of n rows gets fp32 zeros (n, M, d), M the config's
frontend tokens or encoder frames. Zeros reach the output as nothing
(the encoder's memory and the cross K/V are exactly 0), so the
engine's tokens cannot show a fault of the encoder or the
cross-attention; the model-level tests feed a nonzero frontend. The
cross K/V (``xk``/``xv``) are scattered into the slots with the rest of
the cache and are not paged.

``page_pool`` (a ``serving.paging.UnifiedPagePool``, optional) keeps the
accounts of the unified paging the JAX engine keeps: KV pages for each
admitted sequence and the adapter's pages (paged in on first use,
pinned while co-batched) at prefill, growth page by page as tokens are
decoded, and their release when a request finishes or is cancelled. It
only keeps accounts: the cache and the bank are the tensors above.

The hybrid family's bank holds one layer, the shared attention block's
(``lora.adapter.bank_layers``); recurrent state (Mamba2's ``ssm``,
RWKV-6's ``wkv``/``x_tm``/``x_cm``) is scattered into the slots at
prefill as the KV cache is, and a free slot's state runs on in decode
until a prefill overwrites it.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.core.request import Phase, ServeRequest
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import NO_DP
from repro_torch.lora.adapter import Adapter, bank_layers
from repro_torch.lora.bank import build_bank, rank_bucket
from repro_torch.lora.batched import LayoutPlan
from repro_torch.models import model as M
from repro_torch.models.common import all_gather_
from repro_torch.obs import host as obs_host

from .metrics import MetricsCollector
from .paging import UnifiedPagePool
from .sharding import make_engine_sharding, slot_rows

Request = ServeRequest


def _argmax(logits):
    return logits.argmax(dim=-1).to(torch.int32)


class ServingEngine:
    def __init__(self, cfg, params, adapter_ranks: Dict[str, int],
                 *, max_batch: int = 8, max_len: int = 512,
                 seed: int = 0, bank_mode: str = "padded",
                 decode_block: int = 1, lora_kernel: str = "sgmv",
                 mesh=None, page_pool: Optional[UnifiedPagePool] = None,
                 clock: Callable[[], float] = time.monotonic,
                 tracer=None, server_id: int = 0, device="cuda"):
        self.device = resolve_device(device)
        if params.embed.device.type != self.device.type:
            raise ValueError(f"params live on {params.embed.device}, the "
                             f"engine on {self.device}")
        if lora_kernel not in ("einsum", "sgmv"):
            raise ValueError(f"unknown lora kernel {lora_kernel!r}")
        self.cfg = cfg
        # the slot rows this dp replica runs, and the dp group that
        # gathers its tokens where the batch splits (None: every slot here)
        lo, hi = slot_rows(mesh, max_batch)
        self._rows = slice(lo, hi)
        self._dp = mesh.dp if hi - lo < max_batch else None
        # tensor-parallel mode; None (or tp = 1) is the single-device
        # model, exactly; the model splits an expert-parallel prefill over
        # dp only where the slot batch splits
        self.sharding = make_engine_sharding(mesh, cfg)
        self.tp = None
        if self.sharding is not None:
            params = self.sharding.shard_params(params)
            self.tp = mesh if self._dp is not None else \
                dataclasses.replace(mesh, dp=NO_DP)
        # duck-typed obs tracer: per-iteration spans stamped on the engine
        # clock, carrying the batch shape the cost-model drift meter reads
        self.tracer = tracer
        self._track = f"server:{server_id}"
        self.bank_mode = bank_mode
        self.decode_block = decode_block
        self.lora_kernel = lora_kernel
        self.page_pool = page_pool
        self.params = params
        self.max_batch = max_batch
        self.max_len = max_len
        self._clock = clock
        self._bank_seed = seed
        self.slots: List[Optional[ServeRequest]] = [None] * max_batch
        self.slot_adapter = torch.zeros(max_batch, dtype=torch.int32,
                                        device=self.device)
        self.last_token = torch.zeros(max_batch, dtype=torch.int32,
                                      device=self.device)
        self.metrics = MetricsCollector()
        self.queue: List[ServeRequest] = []
        self.completed: List[ServeRequest] = []
        self._iter = 0
        self.bank_rebuilds = 0
        self.decode_dispatches = 0
        self.prefill_dispatches = 0
        self.tokens_decoded = 0
        # SGMV segment layouts built for this engine's batches (one per
        # batch composition that ran, ``LayoutPlan``)
        self.lora_layout_builds = 0

        self.adapter_ranks: Dict[str, int] = {}
        self._rebuild_bank(dict(adapter_ranks))
        self.bank_rebuilds = 0          # the initial build doesn't count
        # the cache is fp32 whatever the params' dtype, as in the JAX engine
        self.enc_len = (cfg.encoder.n_frames if cfg.encoder
                        else (cfg.n_frontend_tokens or None))
        self.cache = M.init_cache(cfg, hi - lo, max_len, torch.float32,
                                  device=self.device, tp=self.tp,
                                  enc_len=self.enc_len)

    # -- placement-aware bank management --------------------------------
    def _rebuild_bank(self, adapter_ranks: Dict[str, int]) -> None:
        self.adapter_ranks = adapter_ranks
        # The JAX engine builds an fp32 bank and casts it to x.dtype in
        # every LoRA call; this bank is built in the params' dtype, which
        # changes no number and at bf16 saves casting the bank every step.
        self.lora_bank = build_bank(self.cfg, adapter_ranks, self._bank_seed,
                                    mode=self.bank_mode,
                                    n_layers=bank_layers(self.cfg),
                                    dtype=self.params.embed.dtype,
                                    device=self.device)
        if self.sharding is not None:
            # every rebuild reshapes the bank; it must stay co-sharded
            self.lora_bank = self.sharding.shard_bank(self.lora_bank)
        self.adapter_ids = list(self.lora_bank.adapter_ids)
        self._adapter_idx = {aid: i
                             for i, aid in enumerate(self.adapter_ids)}
        self.ranks = list(self.lora_bank.ranks)
        self.max_rank = self.lora_bank.max_rank  # padding = subset max
        self.bank = self.lora_bank.data
        self.bank_rebuilds += 1
        # remap adapter indices of co-batched slots to the new bank layout
        idx = [self._adapter_idx[r.adapter_id] if r is not None else 0
               for r in self.slots]
        self.slot_adapter = torch.tensor(idx, dtype=torch.int32,
                                         device=self.device)
        self._slot_lora = self._rows_lora()

    def _rows_lora(self):
        """This replica's slot rows' (bucket, local) bank indices, in the
        plan that builds their decode layout once."""
        return self._plan(self.slot_adapter[self._rows])

    def _plan(self, adapter_idx):
        """The ``lora_idx`` of a batch of global adapter indices: the bank's
        index tensor in a ``LayoutPlan`` that counts its layouts into
        ``lora_layout_builds``."""
        return LayoutPlan(self.lora_bank.lora_idx(adapter_idx),
                          self._layout_built)

    def _layout_built(self) -> None:
        self.lora_layout_builds += 1

    def load_adapters(self, adapter_ranks: Dict[str, int]) -> bool:
        """Add adapters to this server's bank. Returns True if the bank
        was rebuilt."""
        new = {aid: r for aid, r in adapter_ranks.items()
               if aid not in self.adapter_ranks}
        if not new:
            return False
        self._rebuild_bank({**self.adapter_ranks, **new})
        return True

    def adapter_weights(self, adapter_id: str):
        """One adapter's unpadded weights (what a peer reads remotely),
        full width: at tp > 1 the ranks' slices are gathered, so every
        rank calls it."""
        w = self.lora_bank.get_adapter(adapter_id)
        return w if self.sharding is None else self.sharding.gather_adapter(w)

    def install_adapter(self, adapter_id: str, rank: int,
                        weights=None) -> bool:
        """Make ``adapter_id`` servable, with ``weights`` read from a peer
        written over its rows (in place) when given. Peer weights are full
        width; at tp > 1 the rank writes its co-sharded slice. Returns
        True if the bank was rebuilt."""
        added = self.load_adapters({adapter_id: rank})
        if weights is not None:
            if self.sharding is not None:
                weights = self.sharding.shard_adapter(weights)
            self.lora_bank = self.lora_bank.set_adapter(adapter_id, weights)
            self.bank = self.lora_bank.data
        return added

    def evict_adapter(self, adapter_id: str) -> bool:
        """Drop an adapter from the bank. Refuses (returns False) while
        the adapter still has queued or co-batched requests, or if it is
        the server's last adapter."""
        if adapter_id not in self.adapter_ranks:
            return False
        if len(self.adapter_ranks) == 1:
            return False
        if any(r is not None and r.adapter_id == adapter_id
               for r in self.slots):
            return False
        if any(q.adapter_id == adapter_id for q in self.queue):
            return False
        self._rebuild_bank({aid: r for aid, r in self.adapter_ranks.items()
                            if aid != adapter_id})
        return True

    # ------------------------------------------------------------------
    def submit(self, req: ServeRequest) -> None:
        if req.adapter_id not in self.adapter_ranks:
            raise KeyError(f"adapter {req.adapter_id!r} is not loaded on "
                           f"this server (hosted: {self.adapter_ids})")
        self.queue.append(req)

    def _admit(self, now: float) -> None:
        free = [s for s in range(self.max_batch) if self.slots[s] is None]
        if not free or not self.queue:
            return
        take = self.queue[:len(free)]
        del self.queue[:len(take)]
        # FIFO-assign slots, then one prefill call per same-length group
        groups: Dict[int, list] = {}
        for req in take:
            slot = free.pop(0)
            groups.setdefault(len(req.prompt), []).append((slot, req))
        for length, grp in groups.items():
            self._prefill_group(length, grp)
        # slot -> (bucket, local) bank indices and their layout plan once
        # per admit pass
        self._slot_lora = self._rows_lora()
        if self.tracer is not None:
            self.tracer.record("admit", now, self._clock(), cat="host",
                               track=self._track,
                               attrs={"requests": len(take),
                                      "groups": len(groups)})

    def _batch_shape_attrs(self, reqs, value) -> dict:
        """Span attrs describing a batch's rank shape: ``max_rank`` plus,
        in bucketed mode, per-rank-bucket sums of ``value(req)``."""
        ranks = [self.adapter_ranks[r.adapter_id] for r in reqs]
        attrs = {"max_rank": max(ranks), "bank_mode": self.bank_mode}
        if self.bank_mode == "bucketed":
            buckets: Dict[int, int] = {}
            for r, req in zip(ranks, reqs):
                b = rank_bucket(max(1, r))
                buckets[b] = buckets.get(b, 0) + value(req)
            attrs["buckets"] = buckets
        return attrs

    def _prefill_group(self, length: int, grp) -> None:
        t0 = self._clock()
        n = len(grp)
        aidx = [self._adapter_idx[req.adapter_id] for _, req in grp]
        if self.page_pool is not None:
            for ai, (_, req) in zip(aidx, grp):
                self._page_in(req, ai, length)
        parts = None if self.tracer is None else \
            obs_host.open_parts(self._clock)
        built = self.lora_layout_builds
        try:
            toks = torch.tensor([req.prompt for _, req in grp],
                                dtype=torch.int32, device=self.device)
            aidx_t = torch.tensor(aidx, dtype=torch.int32,
                                  device=self.device)
            logits, cache1 = M.prefill(
                self.cfg, self.params, toks, frontend=self.zero_frontend(n),
                bank=self.bank, lora_idx=self._plan(aidx_t),
                cache_len=self.max_len, cache_dtype=torch.float32,
                lora_kernel=self.lora_kernel, tp=self.tp)
            self.prefill_dispatches += 1
            firsts = (_argmax if parts is None
                      else parts.timed("logits", _argmax))(logits)
        finally:
            if parts is not None:
                obs_host.close_parts()
        if parts is not None:
            t_launch = self._clock()
        # analysis: ignore[host-sync] the group's one sync: first tokens
        firsts_host = firsts.tolist()
        if parts is not None:
            t_sync = self._clock()
        slot_ids = [slot for slot, _ in grp]
        slots = torch.tensor(slot_ids, dtype=torch.long, device=self.device)
        self._merge_many(cache1, slot_ids, length)
        self.slot_adapter[slots] = aidx_t
        self.last_token[slots] = firsts
        t = self._clock()
        for i, (slot, req) in enumerate(grp):
            req.phase = Phase.DECODE
            req.slot = slot
            req.output.append(firsts_host[i])
            req.t_first_token = t
            req.prefill_start = t0
            req.prefill_done = t
            self.slots[slot] = req
        if self.tracer is not None:
            reqs = [req for _, req in grp]
            attrs = self._batch_shape_attrs(reqs, lambda r: length)
            attrs.update(tokens=n * length, batch=n)
            self.tracer.record("prefill", t0, t, cat="iteration",
                               track=self._track, attrs=attrs)
            self._record_split("prefill", t0, t_launch, t_sync, parts,
                               built)
            self.tracer.record("prefill.merge", t_sync, t, cat="host",
                               track=self._track, attrs={})

    def zero_frontend(self, n: int):
        """The frontend of a prefill group of ``n`` rows: the JAX engine's
        fp32 zeros (a type-less ``jnp.zeros``) of (n, M, d) for the VLM
        and audio families, None for the others."""
        if not M.n_cross_applications(self.cfg):
            return None
        return torch.zeros((n, self.enc_len, self.cfg.d_model),
                           dtype=torch.float32, device=self.device)

    def _page_in(self, req: ServeRequest, ai: int, length: int) -> None:
        """Unified paging at admission: KV pages for the prompt, and the
        adapter's pages (paged in on first use, pinned while
        co-batched). The adapter's bytes are ``Adapter.nbytes``, the
        placement's formula; a hybrid bank holds one layer of them."""
        self.page_pool.alloc_kv(f"req{req.req_id}", length)
        nbytes = Adapter(req.adapter_id, self.ranks[ai]).nbytes(self.cfg)
        if self.cfg.family == "hybrid":
            nbytes = max(1, nbytes // self.cfg.n_layers)
        self.page_pool.ensure_adapter(req.adapter_id, nbytes)
        self.page_pool.pin_adapter(req.adapter_id)

    def _page_out(self, req: ServeRequest) -> None:
        """Free a finished or cancelled request's KV pages; unpin its
        adapter when no slot holds another of its requests."""
        self.page_pool.free_kv(f"req{req.req_id}")
        if not any(r is not None and r.adapter_id == req.adapter_id
                   for r in self.slots):
            self.page_pool.pin_adapter(req.adapter_id, False)

    def _merge_many(self, cache1, slot_ids, length: int) -> None:
        """Scatter n freshly prefilled rows (batch axis 1 everywhere but
        "pos": KV, cross K/V and recurrent state alike) into their slots
        ``slot_ids``, in place: the rows of this replica's slots only."""
        lo, hi = self._rows.start, self._rows.stop
        mine = [i for i, s in enumerate(slot_ids) if lo <= s < hi]
        if not mine:
            return
        if len(mine) < len(slot_ids):
            src = torch.tensor(mine, dtype=torch.long, device=self.device)
            cache1 = {k: v if k == "pos" else v[:, src]
                      for k, v in cache1.items()}
        slots = torch.tensor([slot_ids[i] - lo for i in mine],
                             dtype=torch.long, device=self.device)
        for k, v in self.cache.items():
            if k == "pos":
                v[slots] = length
            else:
                v[:, slots] = cache1[k].to(v.dtype)

    def _finish_token(self, slot: int, req: ServeRequest, token: int,
                      now: float) -> None:
        """Record one decoded token for a slot; free the slot if done."""
        req.output.append(token)
        self.tokens_decoded += 1
        if self.page_pool is not None:
            self.page_pool.grow_kv(f"req{req.req_id}",
                                   len(req.prompt) + len(req.output))
        done = len(req.output) >= req.max_new_tokens
        if done or len(req.prompt) + len(req.output) >= self.max_len:
            req.phase = Phase.DONE
            req.t_finish = now
            req.finish = now
            self.metrics.record(req)
            self.completed.append(req)
            self.slots[slot] = None
            if self.page_pool is not None:
                self._page_out(req)

    def _decode_fn(self, tokens):
        """One decode step of this replica's slot rows: their next tokens."""
        parts = obs_host.PARTS
        logits, self.cache = M.decode_step(
            self.cfg, self.params, self.cache, tokens, bank=self.bank,
            lora_idx=self._slot_lora, lora_kernel=self.lora_kernel,
            tp=self.tp)
        return (_argmax if parts is None
                else parts.timed("logits", _argmax))(logits)

    def _record_split(self, name, t0, t_launch, t_sync, parts,
                      built: int) -> None:
        """The first host spans of an iteration span that starts at t0:
        ``<name>.launch`` to ``t_launch``, which enqueues the work and
        carries the model parts' host self times and ``lora_layouts``, the
        SGMV segment layouts built since the count read ``built``, then
        ``<name>.sync`` to ``t_sync``, the wait for its tokens."""
        attrs = parts.attrs()
        attrs["lora_layouts"] = self.lora_layout_builds - built
        self.tracer.record(f"{name}.launch", t0, t_launch, cat="host",
                           track=self._track, attrs=attrs)
        self.tracer.record(f"{name}.sync", t_launch, t_sync, cat="host",
                           track=self._track, attrs={})

    def _record_finish(self, t0, tokens: int) -> None:
        """``finish``: the token bookkeeping after a decode span."""
        self.tracer.record("finish", t0, self._clock(), cat="host",
                           track=self._track, attrs={"tokens": tokens})

    def _gather_rows(self, toks):
        """Every replica's slot rows' tokens side by side along the last
        axis (one all-gather over dp); ``toks`` itself where every slot
        runs here."""
        return toks if self._dp is None else all_gather_(toks, self._dp)

    def _decode_once(self) -> None:
        if not any(s is not None for s in self.slots):
            return
        t0 = self._clock()
        active = [r for r in self.slots if r is not None]
        parts = None if self.tracer is None else \
            obs_host.open_parts(self._clock)
        built = self.lora_layout_builds
        try:
            self.last_token = self._gather_rows(
                self._decode_fn(self.last_token[self._rows]))
        finally:
            if parts is not None:
                obs_host.close_parts()
        self.decode_dispatches += 1
        if parts is not None:
            t_launch = self._clock()
        # analysis: ignore[host-sync] the iteration's one sync (A1)
        nxt = self.last_token.tolist()
        now = self._clock()
        if self.tracer is not None:
            attrs = self._batch_shape_attrs(active, lambda r: 1)
            attrs.update(batch=len(active), steps=1, iters=1)
            self.tracer.record("decode", t0, now, cat="iteration",
                               track=self._track, attrs=attrs)
            self._record_split("decode", t0, t_launch, now, parts,
                               built)
        for slot, req in enumerate(self.slots):
            if req is None:
                continue
            self._finish_token(slot, req, nxt[slot], now)
        if self.tracer is not None:
            self._record_finish(now, len(active))
        self._iter += 1

    # -- multi-token decode steps ---------------------------------------
    def decode_steps(self, k: int) -> int:
        """Run ``k`` decode iterations with ONE host sync: on-device argmax
        and per-slot remaining-token counters; rows past their budget
        freeze (their cache position keeps advancing and the token they
        emit repeats and is discarded). Token streams are identical to
        ``k`` single ``step()`` calls. Returns k."""
        if not any(s is not None for s in self.slots):
            return 0
        t0 = self._clock()
        left = [0] * self.max_batch
        for slot, req in enumerate(self.slots):
            if req is None:
                continue
            # an active slot always decodes at least one more token, then
            # finishes on whichever budget it crosses first
            left[slot] = max(1, min(req.max_new_tokens - len(req.output),
                                    self.max_len - len(req.prompt)
                                    - len(req.output)))
        parts = None if self.tracer is None else \
            obs_host.open_parts(self._clock)
        built = self.lora_layout_builds
        try:
            steps_left = torch.tensor(left[self._rows], dtype=torch.int32,
                                      device=self.device)
            tok = self.last_token[self._rows]
            emitted = []
            for _ in range(k):
                nxt = self._decode_fn(tok)
                active = steps_left > 0
                tok = torch.where(active, nxt, tok)
                steps_left = steps_left - active.to(steps_left.dtype)
                emitted.append(tok)
            block = self._gather_rows(torch.stack(emitted))  # (k, max_batch)
        finally:
            if parts is not None:
                obs_host.close_parts()
        self.last_token = block[-1]
        self.decode_dispatches += 1
        if parts is not None:
            t_launch = self._clock()
        # analysis: ignore[host-sync] ONE sync per k tokens (A1)
        toks = block.tolist()
        now = self._clock()
        if self.tracer is not None:
            active_reqs = [r for r in self.slots if r is not None]
            attrs = self._batch_shape_attrs(active_reqs, lambda r: 1)
            attrs.update(batch=len(active_reqs), steps=k, iters=k)
            self.tracer.record("decode", t0, now, cat="iteration",
                               track=self._track, attrs=attrs)
            self._record_split("decode", t0, t_launch, now, parts,
                               built)
        for step in range(k):
            for slot, req in enumerate(self.slots):
                if req is None or step >= left[slot]:
                    continue
                self._finish_token(slot, req, toks[step][slot], now)
        if self.tracer is not None:
            self._record_finish(now, sum(min(n, k) for n in left))
        self._iter += k
        return k

    def step(self) -> None:
        """One engine iteration: admit then decode (prefill-prioritized).
        With ``decode_block > 1`` each step decodes up to that many
        tokens per slot with one host sync."""
        self._admit(self._clock())
        if self.decode_block > 1:
            self.decode_steps(self.decode_block)
        else:
            self._decode_once()

    def drain_completed(self) -> List[ServeRequest]:
        """The requests finished since the last call (the backend's
        completion feed)."""
        done, self.completed = self.completed, []
        return done

    def cancel(self, req_id: int) -> Optional[ServeRequest]:
        """Abort a live request: drop it from the queue, or free its batch
        slot (and its KV pages, and the adapter's pin if it was the last
        co-batched user). Returns the request, or None if it is not live
        here."""
        for r in self.queue:
            if r.req_id == req_id:
                self.queue = [q for q in self.queue if q is not r]
                return r
        for slot, r in enumerate(self.slots):
            if r is not None and r.req_id == req_id:
                self.slots[slot] = None
                if self.page_pool is not None:
                    self._page_out(r)
                return r
        return None

    def run_until_drained(self, max_iters: int = 100_000) -> dict:
        it = 0
        while (self.queue or any(s is not None for s in self.slots)) \
                and it < max_iters:
            self.step()
            it += 1
        return self.metrics.summary()

    @property
    def decode_iterations(self) -> int:
        """Decode steps run so far (k per ``decode_steps(k)`` call)."""
        return self._iter

    @property
    def active(self) -> int:
        return sum(1 for s in self.slots if s is not None)
