"""Async streaming gateway over the incremental ``LoRAServeCluster``.

One asyncio event loop, one pump task, zero locks: handlers and the
pump interleave only at ``await`` points, so every call into the
cluster (submit, register, poll) runs to completion before any other
handler observes state — the single-loop design *is* the concurrency
control. The pump drives ``cluster.poll`` on the cluster clock and fans
completion/token events out to per-request ``asyncio.Queue``s; handlers
await their queue and translate events to SSE frames.

Endpoints (OpenAI-style where applicable):

* ``POST /v1/completions`` — submit a request; SSE per-token streaming
  by default (``"stream": false`` for a single JSON response);
* ``POST /v1/adapters`` / ``DELETE /v1/adapters/{id}`` /
  ``GET /v1/adapters`` — runtime adapter lifecycle (register with
  immediate placement, loss-free retire, live placement/tier table);
* ``GET /metrics`` — Prometheus text format from the incremental
  ``ClusterReport`` snapshot + live telemetry window;
* ``GET /healthz`` — liveness + drain state.

Graceful shutdown (SIGTERM/SIGINT or ``begin_shutdown()``): stop
admitting (503), finish every in-flight request and flush its stream,
complete pending adapter retires, then release backend resources —
zero lost tokens by construction, pinned by ``tests/test_torch_server.py``.

A copy of the JAX package's ``server/gateway.py``. Over the port's
engines the pump steps them on the loop's thread, so a handler waits
out each engine step.
"""
from __future__ import annotations

import asyncio
import itertools
import signal
from typing import Dict, Optional

from repro_torch.core.request import ServeRequest
from repro_torch.core.routing import UnknownAdapterError
from repro_torch.core.types import AdapterInfo

from . import http
from .admission import AdmissionController
from .prom import render_metrics

# default weight payload for adapters registered over HTTP without an
# explicit nbytes (rank-16-ish LoRA on a 7B base)
DEFAULT_ADAPTER_NBYTES = 64 << 20


class _Disconnect:
    """Sentinel queue event: the client's connection is (to be treated
    as) gone — injected by chaos plans or detected via EOF."""
    kind = "disconnect"
    tokens: tuple = ()


_DISCONNECT_EVENT = _Disconnect()


class ServeGateway:
    def __init__(self, cluster, host: str = "127.0.0.1", port: int = 0,
                 *, admission: Optional[AdmissionController] = None,
                 poll_interval: float = 0.002,
                 default_max_tokens: int = 16,
                 submit_retries: int = 3):
        cluster.track_tokens = True   # per-token events feed the SSE path
        self.cluster = cluster
        self.host = host
        self.port = port              # 0: ephemeral; real port after start
        self.admission = admission or AdmissionController()
        self.poll_interval = poll_interval
        self.default_max_tokens = default_max_tokens
        # degradation under faults: transient routing failures (e.g. a
        # crash mid-recovery) are retried this many times before a 503
        self.submit_retries = submit_retries
        self.state = "created"        # serving -> draining -> stopped
        self.codes: Dict[int, int] = {}
        self.streamed_tokens = 0
        self.disconnects = 0          # client-gone streams cancelled
        self.final_report = None
        self._streams: Dict[int, asyncio.Queue] = {}
        self._req_ids = itertools.count(1)
        self._server: Optional[asyncio.AbstractServer] = None
        self._pump_task: Optional[asyncio.Task] = None
        self._stopped: Optional[asyncio.Event] = None

    # -- lifecycle ---------------------------------------------------------
    async def start(self) -> None:
        """Bind the listener, install signal handlers, start the pump.
        Returns once the gateway is accepting connections."""
        assert self.state == "created", f"start() in state {self.state}"
        self._stopped = asyncio.Event()
        self.cluster.start()
        self._server = await asyncio.start_server(
            self._handle_connection, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                loop.add_signal_handler(sig, self.begin_shutdown)
            except (NotImplementedError, RuntimeError, ValueError):
                # non-main-thread loops (test harness) can't install
                # handlers; begin_shutdown() is called directly there
                pass
        self.state = "serving"
        self._pump_task = asyncio.ensure_future(self._pump())

    def begin_shutdown(self) -> None:
        """SIGTERM entry point: stop admitting, let the pump finish all
        in-flight work, then tear down. Safe to call more than once and
        from a signal handler (sync, no awaits)."""
        if self.state in ("draining", "stopped"):
            return
        self.state = "draining"

    async def serve_until_stopped(self) -> None:
        await self._stopped.wait()

    async def _pump(self) -> None:
        """The cluster's event loop: poll on the cluster clock, fan
        events out to request streams, and — once draining — exit when
        everything in flight has finished *and* been flushed."""
        try:
            while True:
                events = self.cluster.poll(self.cluster.clock())
                for ev in events:
                    q = self._streams.get(ev.req.req_id)
                    if q is not None:
                        q.put_nowait(ev)
                # injector-driven client drops (disconnect_client
                # faults): sever the matching live SSE stream
                take = getattr(self.cluster, "take_disconnects", None)
                for target in (take() if take is not None else ()):
                    req_id = target if target in self._streams else (
                        next(iter(self._streams), None))
                    if req_id is None:
                        continue
                    self._streams[req_id].put_nowait(
                        _DISCONNECT_EVENT)
                if self.state == "draining" and self.cluster.idle() \
                        and not self._streams:
                    break
                await asyncio.sleep(self.poll_interval)
        finally:
            await self._teardown()

    async def _teardown(self) -> None:
        self.final_report = self.cluster.report()
        self.cluster.close()
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        self.state = "stopped"
        self._stopped.set()

    # -- connection handling ----------------------------------------------
    async def _handle_connection(self, reader, writer) -> None:
        try:
            while True:
                try:
                    req = await http.read_request(reader)
                except http.BadRequest as e:
                    await self._send(writer, 400, {"error": str(e)},
                                     close=True)
                    break
                if req is None:
                    break
                close = await self._route(req, writer, reader)
                if close or not req.wants_keepalive:
                    break
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    async def _send(self, writer, status: int, body=b"", *,
                    content_type: str = "application/json",
                    headers: Optional[Dict[str, str]] = None,
                    close: bool = False) -> bool:
        self.codes[status] = self.codes.get(status, 0) + 1
        writer.write(http.response_bytes(status, body,
                                         content_type=content_type,
                                         headers=headers, close=close))
        await writer.drain()
        return close

    async def _route(self, req: http.HttpRequest, writer,
                     reader=None) -> bool:
        """Dispatch one request; returns True when the connection must
        close (SSE streams are close-delimited)."""
        method, path = req.method, req.path
        if path == "/healthz" and method == "GET":
            return await self._send(writer, 200, {
                "status": "ok" if self.state == "serving" else self.state,
                "pending": self.cluster.pending(),
                "servers": len(self.cluster.orch.placeable_servers()),
                "adapters": len(self.cluster.meta),
            })
        if path == "/metrics" and method == "GET":
            text = render_metrics(
                self.cluster.snapshot(),
                self.cluster.hub.snapshot(self.cluster.clock()),
                {"state": self.state, "codes": self.codes,
                 "streamed_tokens": self.streamed_tokens,
                 "rejected": self.admission.rejected,
                 "open_streams": len(self._streams),
                 "disconnects": self.disconnects})
            return await self._send(
                writer, 200, text,
                content_type="text/plain; version=0.0.4; charset=utf-8")
        if path == "/v1/adapters" and method == "GET":
            return await self._send(
                writer, 200,
                {"adapters": self.cluster.adapter_entries()})
        if path == "/v1/adapters" and method == "POST":
            return await self._register_adapter(req, writer)
        if path.startswith("/v1/adapters/") and method == "DELETE":
            return await self._unregister_adapter(
                path[len("/v1/adapters/"):], writer)
        if path == "/v1/completions" and method == "POST":
            return await self._completions(req, writer, reader)
        if path in ("/healthz", "/metrics", "/v1/adapters",
                    "/v1/completions"):
            return await self._send(writer, 405,
                                    {"error": f"{method} not allowed"})
        return await self._send(writer, 404,
                                {"error": f"no route for {path}"})

    # -- adapter lifecycle -------------------------------------------------
    async def _register_adapter(self, req, writer) -> bool:
        if self.state != "serving":
            return await self._send(writer, 503,
                                    {"error": "gateway is draining"})
        body = req.json()
        aid = body.get("adapter_id") or body.get("id")
        rank = body.get("rank")
        if not aid or not isinstance(rank, int) or rank <= 0:
            return await self._send(writer, 400, {
                "error": "body must carry adapter_id and a positive "
                         "integer rank"})
        info = AdapterInfo(adapter_id=str(aid), rank=rank,
                           nbytes=int(body.get("nbytes",
                                               DEFAULT_ADAPTER_NBYTES)))
        try:
            sid = self.cluster.register_adapter(info,
                                                now=self.cluster.clock())
        except ValueError as e:
            return await self._send(writer, 409, {"error": str(e)})
        return await self._send(writer, 201, {
            "adapter_id": info.adapter_id, "rank": info.rank,
            "nbytes": info.nbytes, "server": sid})

    async def _unregister_adapter(self, aid: str, writer) -> bool:
        try:
            self.cluster.unregister_adapter(aid,
                                            now=self.cluster.clock())
        except UnknownAdapterError:
            return await self._send(writer, 404, {
                "error": f"adapter {aid!r} is not registered"})
        return await self._send(writer, 202, {
            "adapter_id": aid, "draining": True})

    # -- completions -------------------------------------------------------
    def _build_request(self, body: dict) -> ServeRequest:
        prompt = body.get("prompt")
        max_tokens = int(body.get("max_tokens",
                                  self.default_max_tokens))
        if max_tokens <= 0:
            raise http.BadRequest("max_tokens must be positive")
        aid = body.get("adapter_id") or body.get("model")
        if not aid:
            raise http.BadRequest("body must carry adapter_id (or model)")
        if prompt is not None and not (
                isinstance(prompt, list)
                and all(isinstance(t, int) for t in prompt)):
            raise http.BadRequest("prompt must be a list of token ids")
        plen = body.get("prompt_len",
                        len(prompt) if prompt is not None else 8)
        if not isinstance(plen, int) or plen <= 0:
            raise http.BadRequest("prompt_len must be a positive integer")
        return ServeRequest(
            req_id=next(self._req_ids), adapter_id=str(aid),
            prompt_len=plen, output_len=max_tokens,
            arrival=self.cluster.clock(),
            prompt=list(prompt) if prompt is not None else None)

    async def _completions(self, req, writer, reader=None) -> bool:
        if self.state != "serving":
            return await self._send(
                writer, 503, {"error": "gateway is draining"},
                headers={"Retry-After": "1.000"})
        body = req.json()
        try:
            sreq = self._build_request(body)
        except http.BadRequest as e:
            return await self._send(writer, 400, {"error": str(e)})
        tenant = req.headers.get("x-tenant") or body.get("user") \
            or "default"
        tracer = getattr(self.cluster, "tracer", None)
        t_adm = self.cluster.clock()
        ok, retry_after, reason = self.admission.admit(tenant, t_adm)
        if tracer is not None:
            tracer.record("admission", t_adm, self.cluster.clock(),
                          cat="gateway", track="gateway",
                          req_id=sreq.req_id,
                          attrs={"tenant": tenant, "admitted": ok,
                                 "reason": reason})
        if not ok:
            return await self._send(
                writer, 429,
                {"error": f"admission refused ({reason})",
                 "tenant": tenant, "retry_after": retry_after},
                headers={"Retry-After": f"{max(retry_after, 0.001):.3f}"})
        # register the stream before submitting: the first poll may
        # already carry this request's events
        queue: asyncio.Queue = asyncio.Queue()
        self._streams[sreq.req_id] = queue
        try:
            server = None
            for attempt in range(max(1, self.submit_retries)):
                try:
                    server = self.cluster.submit(sreq,
                                                 self.cluster.clock())
                    break
                except UnknownAdapterError as e:
                    return await self._send(writer, 404,
                                            {"error": str(e)})
                except RuntimeError:
                    # transient routing failure (crash mid-recovery):
                    # let the pump's next poll repair placement, retry
                    await asyncio.sleep(self.poll_interval)
            else:
                return await self._send(
                    writer, 503,
                    {"error": "no server available (recovering)"},
                    headers={"Retry-After":
                             f"{max(self.poll_interval * 10, 0.05):.3f}"})
            if tracer is not None:
                # HTTP receive -> routed/submitted on the cluster clock
                tracer.record("gateway.receive", sreq.arrival,
                              self.cluster.clock(), cat="gateway",
                              track="gateway", req_id=sreq.req_id,
                              attrs={"tenant": tenant, "server": server,
                                     "adapter_id": sreq.adapter_id})
            if body.get("stream", True):
                return await self._stream_response(sreq, server, queue,
                                                   writer, reader)
            return await self._json_response(sreq, server, queue, writer)
        finally:
            self._streams.pop(sreq.req_id, None)
            self.admission.release(tenant)

    def _client_gone(self, sreq) -> bool:
        """The client vanished mid-stream: cancel the request so its
        slot, KV pages and admission token free immediately instead of
        decoding to a dead socket (the pre-chaos gateway leaked the
        slot until the request ran to completion)."""
        self.disconnects += 1
        self.cluster.cancel_request(sreq.req_id)
        return True

    async def _next_stream_event(self, queue, eof_task):
        """Await the next stream event, racing the connection's EOF
        watcher. Returns ``(event, eof_task)``; the event is the
        disconnect sentinel when the client went away."""
        if eof_task is None or eof_task.done():
            return await queue.get(), eof_task
        get_task = asyncio.ensure_future(queue.get())
        await asyncio.wait({get_task, eof_task},
                           return_when=asyncio.FIRST_COMPLETED)
        if eof_task.done():
            try:
                data = eof_task.result()
            except (ConnectionError, OSError):
                data = b""
            if not data:          # EOF: the client hung up
                get_task.cancel()
                return _DISCONNECT_EVENT, None
            eof_task = None       # stray bytes mid-SSE: stop watching
        return await get_task, eof_task

    async def _stream_response(self, sreq, server: int, queue,
                               writer, reader=None) -> bool:
        self.codes[200] = self.codes.get(200, 0) + 1
        writer.write(http.sse_headers())
        await writer.drain()
        # disconnect watcher: an SSE client sends nothing after the
        # request, so a completed read means EOF (or a dying socket)
        eof_task = (asyncio.ensure_future(reader.read(1))
                    if reader is not None else None)
        index = 0
        finished = False
        try:
            while not finished:
                ev, eof_task = await self._next_stream_event(queue,
                                                             eof_task)
                if ev.kind == "disconnect":
                    return self._client_gone(sreq)
                if ev.kind == "timeout":
                    writer.write(http.sse_event(
                        {"id": f"cmpl-{sreq.req_id}",
                         "error": "timeout"}))
                    break
                if ev.tokens:
                    self.streamed_tokens += len(ev.tokens)
                    writer.write(http.sse_event({
                        "id": f"cmpl-{sreq.req_id}",
                        "object": "completion.chunk",
                        "adapter_id": sreq.adapter_id,
                        "index": index,
                        "tokens": list(ev.tokens)}))
                    index += len(ev.tokens)
                if ev.kind == "finish":
                    finished = True
                    writer.write(http.sse_event({
                        "id": f"cmpl-{sreq.req_id}",
                        "object": "completion.chunk",
                        "adapter_id": sreq.adapter_id,
                        "index": index,
                        "tokens": [],
                        "finish_reason": "stop",
                        "usage": self._usage(sreq, server)}))
                try:
                    await writer.drain()
                except (ConnectionError, OSError):
                    return self._client_gone(sreq)
            writer.write(http.sse_event("[DONE]"))
            try:
                await writer.drain()
            except (ConnectionError, OSError):
                return self._client_gone(sreq)
        finally:
            if eof_task is not None:
                eof_task.cancel()
        tracer = getattr(self.cluster, "tracer", None)
        if tracer is not None:
            t = self.cluster.clock()
            tracer.record("stream.finish", t, t, cat="gateway",
                          track="gateway", req_id=sreq.req_id,
                          attrs={"streamed": index})
        return True    # SSE streams are close-delimited

    async def _json_response(self, sreq, server: int, queue,
                             writer) -> bool:
        tokens = []
        while True:
            ev = await queue.get()
            if ev.kind == "timeout":
                return await self._send(writer, 503, {
                    "id": f"cmpl-{sreq.req_id}", "error": "timeout"})
            tokens.extend(t for t in ev.tokens)
            if ev.kind == "finish":
                break
        return await self._send(writer, 200, {
            "id": f"cmpl-{sreq.req_id}",
            "object": "completion",
            "adapter_id": sreq.adapter_id,
            "tokens": tokens,
            "usage": self._usage(sreq, server)})

    def _usage(self, sreq, server: int) -> dict:
        n_out = len(sreq.output) if sreq.output else sreq.decoded
        return {
            "prompt_tokens": sreq.prompt_len,
            "completion_tokens": n_out,
            "server": server,
            "ttft": sreq.ttft,
            "fetch_latency": sreq.fetch_latency,
        }
