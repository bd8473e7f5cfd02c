"""The backend protocol and the real-engine backend of the PyTorch port.

``ServingBackend`` is the contract ``LoRAServeCluster`` drives (a copy of
the JAX package's, in ``serving/backend.py``): submit a request to a
server, advance all servers on a shared clock, drain completion events,
and introspect per-server load and adapter memory.

``EngineBackend`` is the counterpart of the JAX package's: one
placement-aware ``ServingEngine`` per server, each built lazily from the
adapter subset first placed on it, every one over the SAME ``params``
(one copy of the base weights however many servers share the device).
Time is wall-clock seconds since ``start()``. Differences from the JAX
class: ``device`` (default ``"cuda"``) goes to every engine;
``lora_kernel`` defaults to the port's ``"sgmv"``; ``mesh_shape`` and
``page_pool_factory`` are refused (not ported); ``memory_profile``
reports the bytes of the bank the engine holds, which is built in the
params' dtype (half the JAX package's fp32 bytes at bf16). The simulated
substrate (``SimBackend``) is not ported yet.
"""
from __future__ import annotations

import random
import time
from typing import Dict, List, Optional, Protocol, runtime_checkable

from repro_torch.core.request import ServeRequest
from repro_torch.device import resolve_device
from repro_torch.lora.adapter import bank_nbytes



@runtime_checkable
class ServingBackend(Protocol):
    """What a cluster execution substrate must provide."""

    n_servers: int
    realtime: bool    # True: wall clock (poll); False: virtual (jump)

    def start(self) -> None:
        """Called once when a run begins (anchors realtime clocks)."""
        ...

    def submit(self, server_id: int, req: ServeRequest,
               now: float) -> None: ...

    def step(self, now: float) -> None:
        """Advance every server that has runnable work at ``now``."""
        ...

    def next_event_time(self, now: float) -> Optional[float]:
        """Earliest future time anything can happen (virtual backends);
        None when idle or realtime."""
        ...

    def wall_now(self) -> float:
        """Current shared-clock time (realtime backends only)."""
        ...

    def drain_completed(self) -> List[ServeRequest]: ...

    def drain_timed_out(self) -> List[ServeRequest]: ...

    def live_requests(self) -> List[ServeRequest]:
        """Every request currently queued or running (not yet drained).
        Feeds per-token streaming (watermark diffs between steps) and
        adapter-retire quiescence checks."""
        ...

    def pending(self) -> int: ...

    def server_load(self, server_id: int, now: float) -> float: ...

    def queue_depth(self, server_id: int) -> float:
        """Waiting (not-yet-admitted) requests — the controller's
        backlog signal."""
        ...

    def utilization(self, server_id: int, now: float) -> float:
        """Busy fraction (or occupancy proxy) in [0, 1] since the last
        call — gates control-plane drains."""
        ...

    def load_adapters(self, server_id: int,
                      adapter_ranks: Dict[str, int]) -> None: ...

    def load_adapter_remote(self, server_id: int, adapter_id: str,
                            rank: int, peer_server: int) -> None:
        """Make the adapter servable on ``server_id`` by reading its
        weights from ``peer_server``'s copy (GDR remote read) instead of
        loading locally; the copy stays marked remote until promoted."""
        ...

    def promote_adapter(self, server_id: int, adapter_id: str) -> None:
        """Background warm fetch landed: the remote-read copy is now a
        first-class local one."""
        ...

    def evict_adapter(self, server_id: int, adapter_id: str) -> bool: ...

    def hosted_adapters(self, server_id: int) -> Dict[str, int]: ...

    def add_server(self) -> int:
        """Provision one more (empty) server; returns its id. Ids are
        stable — a retired server's id is never reused."""
        ...

    def retire_server(self, server_id: int) -> None:
        """Release a drained server's execution resources. The server
        must have no queued or running work."""
        ...

    def fail_server(self, server_id: int) -> None:
        """Fail-stop: the server freezes mid-flight — queued and
        running requests strand (recoverable via ``drain_failed``), and
        ``step`` never advances it again until restored."""
        ...

    def drain_failed(self, server_id: int) -> List[ServeRequest]:
        """Collect every request stranded on a failed server (queued,
        running, and anything routed to it during the crash-to-detection
        window) and release its execution resources. The requests are
        no longer live; the caller re-dispatches their continuations."""
        ...

    def restore_server(self, server_id: int) -> None:
        """Bring a failed server back, empty (adapters re-load via the
        normal placement path)."""
        ...

    def server_alive(self, server_id: int) -> bool: ...

    def cancel_request(self, req_id: int) -> Optional[ServeRequest]:
        """Abort a live request wherever it sits (queue or batch slot),
        freeing its slot/KV pages. Returns the request, or None if it
        is not live (already finished or unknown)."""
        ...

    def memory_profile(self) -> List[Dict[str, float]]:
        """Per-server {n_adapters, max_rank, adapter_bytes, bank_mode,
        n_remote}."""
        ...


# ----------------------------------------------------------------------
class EngineBackend:
    """Real-engine substrate: one placement-aware ``ServingEngine`` per
    server, created lazily with the adapter subset first loaded onto it.

    The shared clock is wall-clock seconds since ``start()``; request
    arrivals are interpreted in that same relative domain. Simulated
    adapter-fetch latency from the store is recorded on the request (it
    cannot be injected into real execution time). The engines step in
    turn on one device stream: two servers on one card do not overlap.
    """

    realtime = True

    def __init__(self, cfg, params, n_servers: int, *,
                 max_batch: int = 4, max_len: int = 64, seed: int = 0,
                 timeout: float = 120.0, page_pool_factory=None,
                 bank_mode: str = "padded", decode_block: int = 1,
                 lora_kernel: str = "sgmv",
                 mesh_shape: Optional[tuple] = None, device="cuda"):
        from .engine import ServingEngine
        if mesh_shape is not None:
            raise NotImplementedError(
                f"mesh_shape={mesh_shape}: the port's tensor parallelism "
                "runs one process per rank, and wall-clock routing would "
                "diverge between ranks (ROADMAP A9)")
        if page_pool_factory is not None:
            raise NotImplementedError(
                "page_pool_factory: the unified page pool is not ported "
                "yet (ROADMAP A6)")
        self._engine_cls = ServingEngine
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.n_servers = n_servers
        self.bank_mode = bank_mode
        self.decode_block = decode_block
        self.lora_kernel = lora_kernel
        self.max_batch = max_batch
        self.max_len = max_len
        self.seed = seed
        self.timeout = timeout
        self.engines: List[Optional[object]] = [None] * n_servers
        self._remote: List[set] = [set() for _ in range(n_servers)]
        self._t0 = time.monotonic()
        self._timed_out: List[ServeRequest] = []
        self.failed: set = set()

    # -- clock ----------------------------------------------------------
    def start(self) -> None:
        self._t0 = time.monotonic()

    def wall_now(self) -> float:
        return time.monotonic() - self._t0

    def next_event_time(self, now: float) -> Optional[float]:
        return None

    # -- request path ---------------------------------------------------
    def submit(self, server_id: int, req: ServeRequest,
               now: float) -> None:
        eng = self.engines[server_id]
        if eng is None:
            raise RuntimeError(f"server {server_id} has no adapters "
                               f"loaded; call load_adapters first")
        req.server = server_id
        req.ready = now + req.fetch_latency
        if req.prompt is None:
            # length-only (simulator-style) request: synthesize a
            # deterministic prompt so sim traces replay on real engines
            rng = random.Random(req.req_id)
            plen = max(1, min(req.prompt_len,
                              self.max_len - req.output_len - 1))
            req.prompt = [rng.randrange(1, self.cfg.vocab_size)
                          for _ in range(plen)]
        eng.submit(req)

    def step(self, now: float) -> None:
        for sid, eng in enumerate(self.engines):
            if eng is None or sid in self.failed:
                continue   # fail-stop: stranded work freezes until
            # recovery; drop queued (not-yet-admitted) requests past
            # the timeout, mirroring SimBackend's waiting-queue drops
            for r in list(eng.queue):
                if now - r.arrival > self.timeout:
                    eng.queue.remove(r)
                    self._timed_out.append(r)
            if eng.queue or eng.active:
                eng.step()

    def drain_completed(self) -> List[ServeRequest]:
        out: List[ServeRequest] = []
        for sid, eng in enumerate(self.engines):
            if eng is not None and sid not in self.failed:
                out.extend(eng.drain_completed())
        return out

    def drain_timed_out(self) -> List[ServeRequest]:
        out, self._timed_out = self._timed_out, []
        return out

    def live_requests(self) -> List[ServeRequest]:
        out: List[ServeRequest] = []
        for eng in self.engines:
            if eng is None:
                continue
            out.extend(eng.queue)
            out.extend(r for r in eng.slots if r is not None)
        return out

    def pending(self) -> int:
        return sum(len(e.queue) + e.active
                   for e in self.engines if e is not None)

    def server_load(self, server_id: int, now: float) -> float:
        eng = self.engines[server_id]
        return 0.0 if eng is None else float(len(eng.queue) + eng.active)

    def queue_depth(self, server_id: int) -> float:
        eng = self.engines[server_id]
        return 0.0 if eng is None else float(len(eng.queue))

    def utilization(self, server_id: int, now: float) -> float:
        """Instantaneous batch occupancy — the closest cheap proxy for
        busy fraction on a real engine."""
        eng = self.engines[server_id]
        if eng is None:
            return 0.0
        return min(1.0, eng.active / max(1, self.max_batch))

    # -- placement path -------------------------------------------------
    def load_adapters(self, server_id: int,
                      adapter_ranks: Dict[str, int]) -> None:
        if not adapter_ranks:
            return
        if self.engines[server_id] is None:
            self.engines[server_id] = self._engine_cls(
                self.cfg, self.params, dict(adapter_ranks),
                max_batch=self.max_batch, max_len=self.max_len,
                seed=self.seed, bank_mode=self.bank_mode,
                decode_block=self.decode_block,
                lora_kernel=self.lora_kernel, clock=self.wall_now,
                server_id=server_id, device=self.device)
        else:
            self.engines[server_id].load_adapters(adapter_ranks)

    def load_adapter_remote(self, server_id: int, adapter_id: str,
                            rank: int, peer_server: int) -> None:
        """Remote read on the real substrate: the adapter's weights are
        read out of the *peer engine's* bank and written into this
        server's bank, device to device, without local materialization.
        Falls back to a local load when the peer copy is unavailable."""
        weights = None
        if 0 <= peer_server < self.n_servers:
            peer = self.engines[peer_server]
            if peer is not None and adapter_id in peer.adapter_ranks:
                weights = peer.adapter_weights(adapter_id)
        eng = self.engines[server_id]
        if eng is None:
            self.load_adapters(server_id, {adapter_id: rank})
            eng = self.engines[server_id]
            if weights is not None:
                eng.install_adapter(adapter_id, rank, weights)
        else:
            eng.install_adapter(adapter_id, rank, weights)
        if weights is not None:
            self._remote[server_id].add(adapter_id)

    def promote_adapter(self, server_id: int, adapter_id: str) -> None:
        self._remote[server_id].discard(adapter_id)

    def evict_adapter(self, server_id: int, adapter_id: str) -> bool:
        eng = self.engines[server_id]
        if eng is None:
            return False
        if eng.evict_adapter(adapter_id):
            self._remote[server_id].discard(adapter_id)
            return True
        return False

    def hosted_adapters(self, server_id: int) -> Dict[str, int]:
        eng = self.engines[server_id]
        return {} if eng is None else dict(eng.adapter_ranks)

    def add_server(self) -> int:
        sid = self.n_servers
        self.n_servers += 1
        self.engines.append(None)   # engine builds lazily on first load
        self._remote.append(set())
        return sid

    def retire_server(self, server_id: int) -> None:
        eng = self.engines[server_id]
        if eng is not None and (eng.queue or eng.active):
            raise RuntimeError(f"retire of engine {server_id} with "
                               f"work still queued")
        self.engines[server_id] = None   # frees the bank
        self._remote[server_id].clear()

    # -- fault plane ----------------------------------------------------
    def fail_server(self, server_id: int) -> None:
        self.failed.add(server_id)

    def drain_failed(self, server_id: int) -> List[ServeRequest]:
        eng = self.engines[server_id]
        if eng is None:
            return []
        stranded = list(eng.queue) + [r for r in eng.slots
                                      if r is not None]
        # a crashed engine's bank, KV cache, and queue all die with it
        self.engines[server_id] = None
        self._remote[server_id].clear()
        return stranded

    def restore_server(self, server_id: int) -> None:
        self.failed.discard(server_id)   # engine rebuilds on next load

    def server_alive(self, server_id: int) -> bool:
        return server_id not in self.failed

    def cancel_request(self, req_id: int) -> Optional[ServeRequest]:
        for eng in self.engines:
            if eng is None:
                continue
            r = eng.cancel(req_id)
            if r is not None:
                return r
        return None

    def memory_profile(self) -> List[Dict[str, float]]:
        out = []
        for sid, eng in enumerate(self.engines):
            if eng is None:
                out.append({"n_adapters": 0, "max_rank": 0,
                            "adapter_bytes": 0,
                            "bank_mode": self.bank_mode,
                            "n_remote": 0})
            else:
                out.append({"n_adapters": len(eng.adapter_ids),
                            "max_rank": eng.max_rank,
                            "adapter_bytes": bank_nbytes(eng.bank),
                            "bank_mode": eng.bank_mode,
                            "n_remote": len(self._remote[sid])})
        return out
