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
``lora_kernel`` defaults to the port's ``"sgmv"``; ``page_pool_factory``
gives each engine a pool of its own, as in the JAX package;
``memory_profile`` reports the bytes of the bank the engine holds (on
one rank's card, under a mesh), which is built in the params' dtype
(half the JAX package's fp32 bytes at bf16).

``mesh_shape=(dp, tp)`` serves every server on a (dp, tp) mesh, as the
JAX backend does, where every server's mesh spans the same devices: the
port runs one process per rank of a world of dp * tp
(``launch.mesh.spawn``), and every rank builds the backend, holding its
slice of every server's engine and one copy of its slice of the
weights. Rank 0 leads: it runs the facade (``LoRAServeCluster``), and
every backend call that touches an engine is sent, with its arguments
(rank 0's ``now`` among them), to the other ranks over a gloo group
before it runs; they follow (``serve_follower``), applying the calls in
rank 0's order, so their engines meet rank 0's in every collective. Only
rank 0 routes, so wall-clock routing cannot diverge. Rank 0's
``close()`` stops the followers.

``SimBackend`` is a copy of the JAX package's discrete-event substrate
(``SimServer`` + the ``ServerModel`` cost model of the paper's A100
fleet). It runs on the host by nature, on virtual time: a cost model,
not a device path.
"""
from __future__ import annotations

import functools
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
class SimBackend:
    """Discrete-event substrate over ``SimServer`` + ``ServerModel``."""

    realtime = False

    def __init__(self, n_servers: int, server_model=None,
                 timeout: float = 120.0,
                 adapter_nbytes: Optional[Dict[str, int]] = None,
                 bank_mode: str = "padded", decode_block: int = 1,
                 mesh_shape: Optional[tuple] = None):
        from repro_torch.cluster.costmodel import ServerModel
        from repro_torch.cluster.server import SimServer
        self.n_servers = n_servers
        self.bank_mode = bank_mode
        self.decode_block = decode_block
        self.mesh_shape = mesh_shape
        if server_model is None:
            # mesh-sharded servers: tp follows the mesh's "model" extent
            # and iteration times include the explicit ICI terms
            server_model = ServerModel(mesh_shape=mesh_shape,
                                       tp=mesh_shape[-1]) \
                if mesh_shape else ServerModel()
        self.model = server_model
        self.servers = [SimServer(i, self.model, bank_mode=bank_mode,
                                  decode_block=decode_block)
                        for i in range(n_servers)]
        self.timeout = timeout
        self._nbytes = adapter_nbytes or {}
        self._hosted: List[Dict[str, int]] = [{} for _ in range(n_servers)]
        self._remote: List[set] = [set() for _ in range(n_servers)]
        self._inflight: List[ServeRequest] = []
        self._completed: List[ServeRequest] = []
        self._timed_out: List[ServeRequest] = []
        self._util_prev: Dict[int, tuple] = {}
        self.failed: set = set()
        self.tracer = None

    def set_tracer(self, tracer) -> None:
        """Attach an ``obs.Tracer``; servers emit iteration spans on the
        virtual clock (applies to servers added later too)."""
        self.tracer = tracer
        for s in self.servers:
            s.tracer = tracer

    def start(self) -> None:
        pass

    def flush_spans(self) -> None:
        """Emit any staged (coalesced) decode spans — called before a
        report/snapshot reads the tracer, so span totals and drift
        cover every iteration executed so far."""
        for s in self.servers:
            s.flush_spans()

    def submit(self, server_id: int, req: ServeRequest,
               now: float) -> None:
        req.server = server_id
        req.ready = now + req.fetch_latency
        self.servers[server_id].enqueue(req)
        self._inflight.append(req)

    def step(self, now: float) -> None:
        for sid, s in enumerate(self.servers):
            if sid in self.failed:
                continue   # fail-stop: stranded work neither runs
            for r in list(s.waiting):   # nor times out — it recovers
                if now - r.arrival > self.timeout:
                    s.waiting.remove(r)
                    self._inflight.remove(r)
                    self._timed_out.append(r)
            if s.busy_until <= now + 1e-12 and s.has_work(now):
                s.step(now)
            s.finished.clear()   # completions flow via _completed here
        still = []
        for r in self._inflight:
            (self._completed if r.finish >= 0 else still).append(r)
        self._inflight = still

    def next_event_time(self, now: float) -> Optional[float]:
        ts = [t for sid, s in enumerate(self.servers)
              if sid not in self.failed
              for t in (s.next_event_time(now),) if t is not None]
        return min(ts) if ts else None

    def wall_now(self) -> float:
        raise RuntimeError("SimBackend has no wall clock; virtual time "
                           "is driven by the cluster facade")

    def drain_completed(self) -> List[ServeRequest]:
        done, self._completed = self._completed, []
        return done

    def drain_timed_out(self) -> List[ServeRequest]:
        out, self._timed_out = self._timed_out, []
        return out

    def live_requests(self) -> List[ServeRequest]:
        return list(self._inflight)

    def pending(self) -> int:
        return len(self._inflight)

    def server_load(self, server_id: int, now: float) -> float:
        return self.servers[server_id].estimated_work(now)

    def queue_depth(self, server_id: int) -> float:
        return float(len(self.servers[server_id].waiting))

    def utilization(self, server_id: int, now: float) -> float:
        """Busy fraction since the previous call for this server."""
        s = self.servers[server_id]
        t0, b0 = self._util_prev.get(server_id, (0.0, 0.0))
        self._util_prev[server_id] = (now, s.busy_time)
        if now <= t0:
            return 0.0
        return min(1.0, max(0.0, (s.busy_time - b0) / (now - t0)))

    def load_adapters(self, server_id: int,
                      adapter_ranks: Dict[str, int]) -> None:
        self._hosted[server_id].update(adapter_ranks)
        self._remote[server_id] -= set(adapter_ranks)

    def load_adapter_remote(self, server_id: int, adapter_id: str,
                            rank: int, peer_server: int) -> None:
        # virtual substrate: the cost model charges the GDR streaming
        # tax via req.remote_penalty; here we just track residency
        self._hosted[server_id][adapter_id] = rank
        self._remote[server_id].add(adapter_id)

    def promote_adapter(self, server_id: int, adapter_id: str) -> None:
        self._remote[server_id].discard(adapter_id)

    def evict_adapter(self, server_id: int, adapter_id: str) -> bool:
        # refuse while the adapter still has requests on this server
        if any(r.adapter_id == adapter_id and r.server == server_id
               for r in self._inflight):
            return False
        self._remote[server_id].discard(adapter_id)
        return self._hosted[server_id].pop(adapter_id, None) is not None

    def hosted_adapters(self, server_id: int) -> Dict[str, int]:
        return dict(self._hosted[server_id])

    def add_server(self) -> int:
        from repro_torch.cluster.server import SimServer
        sid = self.n_servers
        self.n_servers += 1
        self.servers.append(SimServer(sid, self.model,
                                      bank_mode=self.bank_mode,
                                      decode_block=self.decode_block,
                                      tracer=self.tracer))
        self._hosted.append({})
        self._remote.append(set())
        return sid

    def retire_server(self, server_id: int) -> None:
        s = self.servers[server_id]
        if s.waiting or s.running:
            raise RuntimeError(f"retire of sim server {server_id} with "
                               f"work still queued")
        self._hosted[server_id].clear()
        self._remote[server_id].clear()

    # -- fault plane ----------------------------------------------------
    def fail_server(self, server_id: int) -> None:
        self.failed.add(server_id)

    def drain_failed(self, server_id: int) -> List[ServeRequest]:
        s = self.servers[server_id]
        stranded = list(s.waiting) + list(s.running)
        s.waiting.clear()
        s.running.clear()
        s.finished.clear()
        s.busy_until = 0.0
        gone = {id(r) for r in stranded}
        self._inflight = [r for r in self._inflight
                          if id(r) not in gone]
        self._hosted[server_id].clear()
        self._remote[server_id].clear()
        return stranded

    def restore_server(self, server_id: int) -> None:
        self.failed.discard(server_id)
        self._util_prev.pop(server_id, None)

    def server_alive(self, server_id: int) -> bool:
        return server_id not in self.failed

    def cancel_request(self, req_id: int) -> Optional[ServeRequest]:
        for r in self._inflight:
            if r.req_id == req_id:
                s = self.servers[r.server]
                s.waiting[:] = [q for q in s.waiting if q is not r]
                s.running[:] = [q for q in s.running if q is not r]
                self._inflight = [q for q in self._inflight
                                  if q is not r]
                return r
        return None

    def memory_profile(self) -> List[Dict[str, float]]:
        out = []
        for sid, hosted in enumerate(self._hosted):
            out.append({
                "n_adapters": len(hosted),
                "max_rank": max(hosted.values()) if hosted else 0,
                "adapter_bytes": sum(self._nbytes.get(a, 0)
                                     for a in hosted),
                "bank_mode": self.bank_mode,
                "n_remote": len(self._remote[sid]),
            })
        return out


# ----------------------------------------------------------------------
class _Channel:
    """Rank 0's backend calls, broadcast to every rank of the world over a
    gloo group of them all (made here: every rank constructs it, in the
    same order as its other groups)."""

    def __init__(self):
        import torch.distributed as dist
        self._dist = dist
        self.group = dist.new_group(backend="gloo")
        self.leader = dist.get_rank() == 0

    def send(self, msg) -> None:
        self._dist.broadcast_object_list([msg], src=0, group=self.group)

    def recv(self):
        box = [None]
        self._dist.broadcast_object_list(box, src=0, group=self.group)
        return box[0]


def _mirrored(fn):
    """A backend call that touches an engine: on rank 0 of a mesh it is
    sent to the followers before it runs (the outermost call only: one
    that another makes runs on every rank by itself), with the outcome of
    the call before it (the type of its exception, or None), which each
    follower holds against its own."""
    @functools.wraps(fn)
    def call(self, *args, **kw):
        ch = self._channel
        if ch is None or not ch.leader or self._depth:
            return fn(self, *args, **kw)
        ch.send((fn.__name__, args, kw, self._outcome))
        self._depth += 1
        self._outcome = None
        try:
            return fn(self, *args, **kw)
        except Exception as e:
            self._outcome = type(e).__name__
            raise
        finally:
            self._depth -= 1
    return call


def serve_follower(backend) -> None:
    """A rank other than 0 of a mesh-sharded ``EngineBackend``: apply rank
    0's calls in its order until it closes. Each call's outcome must be
    rank 0's (a deterministic call fails on every rank alike); the
    completions and timeouts a step makes are rank 0's to report, and
    are dropped here."""
    ch, mine = backend._channel, None
    while True:
        msg = ch.recv()
        if msg is None:
            return
        name, args, kw, theirs = msg
        if theirs != mine:
            raise RuntimeError(f"rank 0's call before {name!r} ended in "
                               f"{theirs}, this rank's in {mine}")
        mine = None
        try:
            getattr(backend, name)(*args, **kw)
        except Exception as e:
            mine = type(e).__name__
        if name == "step":
            backend.drain_completed()
            backend.drain_timed_out()


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
        self._engine_cls = ServingEngine
        self._page_pool_factory = page_pool_factory
        self.device = resolve_device(device)
        self.cfg = cfg
        # mesh-sharded engines: every server's engine over this rank's
        # place in the (dp, tp) mesh (outside a world of dp * tp ranks
        # ``make_engine_mesh`` refuses), over one shared copy of its slice
        # of the weights; None keeps the single-device engines unchanged
        self.mesh_shape = mesh_shape
        self.mesh = self._channel = None
        self._depth, self._outcome = 0, None
        if mesh_shape is not None:
            from repro_torch.launch.mesh import make_engine_mesh

            from .sharding import make_engine_sharding
            self.mesh = make_engine_mesh(*mesh_shape, device=self.device)
            sharding = make_engine_sharding(self.mesh, cfg)
            if sharding is not None:
                params = sharding.shard_params(params)
            if mesh_shape[0] * mesh_shape[1] > 1:
                self._channel = _Channel()
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
        self.tracer = None

    def set_tracer(self, tracer) -> None:
        """Attach an ``obs.Tracer``; engines (built lazily) emit
        iteration spans on the shared wall clock."""
        self.tracer = tracer
        for eng in self.engines:
            if eng is not None:
                eng.tracer = tracer

    def flush_spans(self) -> None:
        """Nothing to emit: an engine records each iteration's span as
        the iteration ends, after its host sync, and stages none."""

    # -- clock ----------------------------------------------------------
    def start(self) -> None:
        self._t0 = time.monotonic()

    def wall_now(self) -> float:
        return time.monotonic() - self._t0

    def next_event_time(self, now: float) -> Optional[float]:
        return None

    # -- the mesh's followers -------------------------------------------
    def close(self) -> None:
        """On rank 0 of a mesh, stop the followers (``serve_follower``
        returns); nothing elsewhere."""
        if self._channel is not None and self._channel.leader:
            self._channel.send(None)
            self._channel = None

    # -- request path ---------------------------------------------------
    @_mirrored
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

    @_mirrored
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
    @_mirrored
    def load_adapters(self, server_id: int,
                      adapter_ranks: Dict[str, int]) -> None:
        if not adapter_ranks:
            return
        if self.engines[server_id] is None:
            pool = (self._page_pool_factory()
                    if self._page_pool_factory else None)
            self.engines[server_id] = self._engine_cls(
                self.cfg, self.params, dict(adapter_ranks),
                max_batch=self.max_batch, max_len=self.max_len,
                seed=self.seed, bank_mode=self.bank_mode,
                decode_block=self.decode_block,
                lora_kernel=self.lora_kernel, page_pool=pool,
                clock=self.wall_now,
                mesh=self.mesh, tracer=self.tracer, server_id=server_id,
                device=self.device)
        else:
            self.engines[server_id].load_adapters(adapter_ranks)

    @_mirrored
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

    @_mirrored
    def promote_adapter(self, server_id: int, adapter_id: str) -> None:
        self._remote[server_id].discard(adapter_id)

    @_mirrored
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

    @_mirrored
    def add_server(self) -> int:
        sid = self.n_servers
        self.n_servers += 1
        self.engines.append(None)   # engine builds lazily on first load
        self._remote.append(set())
        return sid

    @_mirrored
    def retire_server(self, server_id: int) -> None:
        eng = self.engines[server_id]
        if eng is not None and (eng.queue or eng.active):
            raise RuntimeError(f"retire of engine {server_id} with "
                               f"work still queued")
        self.engines[server_id] = None   # frees the bank
        self._remote[server_id].clear()

    # -- fault plane ----------------------------------------------------
    @_mirrored
    def fail_server(self, server_id: int) -> None:
        self.failed.add(server_id)

    @_mirrored
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

    @_mirrored
    def restore_server(self, server_id: int) -> None:
        self.failed.discard(server_id)   # engine rebuilds on next load

    def server_alive(self, server_id: int) -> bool:
        return server_id not in self.failed

    @_mirrored
    def cancel_request(self, req_id: int) -> Optional[ServeRequest]:
        for eng in self.engines:
            if eng is None:
                continue
            r = eng.cancel(req_id)
            if r is not None:
                return r
        return None

    def memory_profile(self) -> List[Dict[str, float]]:
        """Each server's bank: its adapters, padding rank and bytes, as
        this process's engine holds it (under a mesh, one rank's
        co-sharded slice, on one rank's card)."""
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
