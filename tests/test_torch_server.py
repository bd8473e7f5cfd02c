"""PyTorch port, streaming gateway (``repro_torch.server``) and its
launchers: the JAX package's ``tests/test_server.py`` on the port, and
the port against the JAX package where both serve the same request.

Over ``SimBackend``: SSE ordering and ``/healthz``, 404s, the runtime
adapter lifecycle over HTTP, per-tenant 429s, a SIGTERM drain that loses
no token, and the incremental cluster API. Over the port's engines
(reduced llama-7b-paper, fp32, bridged base weights, nonzero seeded
adapter weights): an adapter registered over HTTP streams the tokens of
the port's batch ``run`` and of the JAX gateway, an adapter deleted while
its stream is in flight finishes it, and a drain loses no token. The
launchers ``python -m repro_torch.launch.server`` and ``launch.serve
--serve`` exit 0 on SIGTERM, and refuse to start without a card unless
told ``--device cpu``."""
import asyncio
import copy
import http.client
import json
import math
import os
import random
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest
import torch

from _torch_jax_side import JaxSeededBackend, plain, seeded_setup
from repro.cluster import NetworkModel as JNetworkModel
from repro.core import AdapterInfo as JAdapterInfo
from repro.server import AdmissionController as JAdmissionController
from repro.server import ServeGateway as JServeGateway
from repro.server import http as jhttp
from repro.serving import LoRAServeCluster as JCluster
from repro_torch.cluster import NetworkModel
from repro_torch.core import AdapterInfo, ServeRequest, UnknownAdapterError
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import server as launch_server
from repro_torch.launch.serve import SeededWeightsBackend
from repro_torch.server import AdmissionController, ServeGateway
from repro_torch.server import http as thttp
from repro_torch.serving import ClusterReport, LoRAServeCluster, SimBackend

ROOT = Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------
# harness: the asyncio gateway in a thread, driven over real HTTP
# ---------------------------------------------------------------------
class GatewayHarness:
    def __init__(self, cluster, gateway_cls=ServeGateway, **kw):
        self.gw = gateway_cls(cluster, port=0, **kw)
        self._ready = threading.Event()
        self.loop = None
        self.thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        self.loop = asyncio.new_event_loop()
        asyncio.set_event_loop(self.loop)

        async def main():
            await self.gw.start()
            self._ready.set()
            await self.gw.serve_until_stopped()

        try:
            self.loop.run_until_complete(main())
        finally:
            self.loop.close()

    def __enter__(self):
        self.thread.start()
        assert self._ready.wait(60), "gateway failed to start"
        return self

    def shutdown(self, timeout=120):
        """What SIGTERM does: the installed handler is begin_shutdown."""
        if self.thread.is_alive():
            self.loop.call_soon_threadsafe(self.gw.begin_shutdown)
            self.thread.join(timeout)
        assert not self.thread.is_alive(), "gateway failed to drain"

    def __exit__(self, *exc):
        self.shutdown()

    @property
    def port(self):
        return self.gw.port


def http_json(port, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    hdrs = {"Content-Type": "application/json", **(headers or {})}
    conn.request(method, path,
                 json.dumps(body) if body is not None else None, hdrs)
    resp = conn.getresponse()
    raw = resp.read()
    out_headers = {k.lower(): v for k, v in resp.getheaders()}
    conn.close()
    try:
        parsed = json.loads(raw) if raw else {}
    except ValueError:
        parsed = raw.decode("utf-8", "replace")
    return resp.status, parsed, out_headers


def sse_request(port, payload, headers=None, on_tokens=None):
    """POST /v1/completions, streamed; (status, the SSE frames up to
    ``[DONE]``). ``on_tokens`` is called after each frame with tokens."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    hdrs = {"Content-Type": "application/json", **(headers or {})}
    conn.request("POST", "/v1/completions", json.dumps(payload), hdrs)
    resp = conn.getresponse()
    if resp.status != 200:
        resp.read()
        conn.close()
        return resp.status, []
    chunks = []
    while True:
        line = resp.fp.readline()
        if not line:
            break
        line = line.decode("utf-8").strip()
        if not line.startswith("data: "):
            continue
        if line == "data: [DONE]":
            break
        chunks.append(json.loads(line[len("data: "):]))
        if on_tokens is not None and chunks[-1].get("tokens"):
            on_tokens()
    conn.close()
    return 200, chunks


def tokens_of(chunks):
    return [t for c in chunks for t in (c.get("tokens") or [])]


def assert_in_order(chunks, n):
    """Chunk indices strictly ordered and gapless, ``n`` tokens, a stop."""
    seen = 0
    for c in chunks:
        assert c["index"] == seen
        seen += len(c["tokens"])
    assert seen == n
    assert chunks[-1]["finish_reason"] == "stop"


def make_sim_cluster(n_servers=2, n_adapters=4, seed=0, **kw):
    adapters = [AdapterInfo(f"a{i}-r{[8, 16, 32, 64][i % 4]}",
                            [8, 16, 32, 64][i % 4], nbytes=8 << 20)
                for i in range(n_adapters)]
    backend = SimBackend(n_servers, adapter_nbytes={
        a.adapter_id: a.nbytes for a in adapters})
    return LoRAServeCluster(backend, adapters, network=NetworkModel(),
                            rebalance_period=kw.pop("rebalance_period", 1e9),
                            seed=seed, **kw), adapters


# ---------------------------------------------------------------------
# the incremental cluster API (no HTTP)
# ---------------------------------------------------------------------
def test_incremental_api_matches_batch_run():
    """submit/poll/drain on the event clock reproduces ``run``: same
    routing, completions and TTFTs."""
    rng = random.Random(3)
    reqs = [ServeRequest(req_id=i, adapter_id=f"a{rng.randrange(4)}-"
                         f"r{[8, 16, 32, 64][rng.randrange(4) % 4]}",
                         prompt_len=16, output_len=6, arrival=i * 0.02)
            for i in range(12)]
    ranks = {r.adapter_id: int(r.adapter_id.split("-r")[1]) for r in reqs}
    adapters = [AdapterInfo(aid, rk, nbytes=8 << 20)
                for aid, rk in sorted(ranks.items())]

    def make():
        be = SimBackend(2, adapter_nbytes={a.adapter_id: a.nbytes
                                           for a in adapters})
        return LoRAServeCluster(be, adapters, network=NetworkModel(), seed=5)

    batch = make()
    batch_rep = batch.run(copy.deepcopy(reqs))
    inc = make()
    inc.start()
    todo = sorted(copy.deepcopy(reqs), key=lambda r: r.arrival)
    i, now = 0, 0.0
    while i < len(todo) or inc.pending():
        while i < len(todo) and todo[i].arrival <= now + 1e-12:
            inc.submit(todo[i], now)
            i += 1
        inc.poll(now)
        nxt = inc._next_time(now, i < len(todo),
                             todo[i].arrival if i < len(todo) else None)
        if nxt is None:
            break
        now = max(now, nxt)
    inc.drain()
    inc_rep = inc.report()
    assert inc.routed == batch.routed
    assert inc_rep.completed() == batch_rep.completed() == len(reqs)
    assert sorted(r.ttft for r in inc_rep.results) == \
        sorted(r.ttft for r in batch_rep.results)


def test_cluster_register_unregister_lifecycle():
    cluster, _ = make_sim_cluster()
    cluster.start()
    sid = cluster.register_adapter(AdapterInfo("newbie", 16, nbytes=8 << 20))
    assert cluster.orch.placement["newbie"] == {sid: 1.0}
    cluster.submit(ServeRequest(req_id=1, adapter_id="newbie", prompt_len=8,
                                output_len=4, arrival=0.0), 0.0)
    evs = cluster.drain()
    assert any(e.kind == "finish" and e.req.req_id == 1 for e in evs)
    cluster.unregister_adapter("newbie")
    with pytest.raises(UnknownAdapterError):
        cluster.submit(ServeRequest(req_id=2, adapter_id="newbie",
                                    prompt_len=8, output_len=4,
                                    arrival=0.0), 0.0)
    cluster.drain()
    assert "newbie" not in cluster.meta
    assert "newbie" not in cluster.orch.store.meta
    rep = cluster.report()
    assert rep.registered == 1 and rep.unregistered == 1
    with pytest.raises(UnknownAdapterError):
        cluster.unregister_adapter("newbie")


def test_unregister_busy_adapter_is_loss_free():
    cluster, adapters = make_sim_cluster()
    cluster.track_tokens = True
    cluster.start()
    aid = adapters[0].adapter_id
    cluster.submit(ServeRequest(req_id=7, adapter_id=aid, prompt_len=16,
                                output_len=24, arrival=0.0), 0.0)
    evs = cluster.poll(0.0)
    cluster.unregister_adapter(aid)
    assert cluster._retiring == {aid}
    evs += cluster.drain()
    assert sum(len(e.tokens) for e in evs if e.req.req_id == 7) == 24
    assert not cluster._retiring and aid not in cluster.meta
    assert cluster.report().unregistered == 1


def test_report_percentiles_safe_on_empty_window():
    rep = ClusterReport(results=[], summary={}, rebalances=0, placements=[],
                        per_server_counts=[], timed_out=0, fetches=0,
                        fetch_bytes=0, max_adapters_per_server=0,
                        total_adapter_bytes=0, memory_profile=[])
    assert math.isnan(rep.p50_ttft()) and math.isnan(rep.p95_ttft())
    assert rep.mean_tbt() == 0.0 and rep.completed() == 0
    assert not rep.meets_slo(1.0) and rep.slo_attainment(1.0) == 1.0


def test_snapshot_mid_flight():
    cluster, adapters = make_sim_cluster()
    cluster.start()
    for i in range(4):
        cluster.submit(ServeRequest(
            req_id=i, adapter_id=adapters[i % len(adapters)].adapter_id,
            prompt_len=16, output_len=50, arrival=0.0), 0.0)
    cluster.poll(0.0)
    snap = cluster.snapshot()
    assert snap.in_progress == 4 and snap.completed() == 0
    assert math.isnan(snap.p95_ttft())
    cluster.drain()
    final = cluster.snapshot()
    assert final.in_progress == 0 and final.completed() == 4


# ---------------------------------------------------------------------
# HTTP framing and admission against the JAX package's
# ---------------------------------------------------------------------
RAW_REQUESTS = [
    b"GET /healthz HTTP/1.1\r\nHost: x\r\n\r\n",
    b"POST /v1/completions?x=1 HTTP/1.1\r\nContent-Type: application/json"
    b"\r\nContent-Length: 27\r\nX-Tenant: t1\r\n\r\n"
    b'{"adapter_id": "a", "n": 1}',
    b"DELETE /v1/adapters/ad%201 HTTP/1.0\r\nConnection: keep-alive\r\n\r\n",
    b"BROKEN\r\n\r\n",
    b"POST / HTTP/1.1\r\nContent-Length: zz\r\n\r\n",
    b"",
]


def _parse(mod, raw):
    async def go():
        reader = asyncio.StreamReader()
        reader.feed_data(raw)
        reader.feed_eof()
        try:
            req = await mod.read_request(reader)
        except mod.BadRequest as e:
            return ("bad", str(e))
        return None if req is None else plain(req)
    return asyncio.run(go())


@pytest.mark.parametrize("i", range(len(RAW_REQUESTS)))
def test_http_parsing_equals_the_jax_packages(i):
    assert _parse(thttp, RAW_REQUESTS[i]) == _parse(jhttp, RAW_REQUESTS[i])


def test_http_framing_equals_the_jax_packages():
    for mod in (thttp, jhttp):
        assert mod.sse_event({"a": 1}) == jhttp.sse_event({"a": 1})
        assert mod.sse_headers() == jhttp.sse_headers()
    assert thttp.response_bytes(429, {"e": 1}, headers={"Retry-After": "1"}) \
        == jhttp.response_bytes(429, {"e": 1}, headers={"Retry-After": "1"})


def _admissions(cls, seed):
    rng = random.Random(seed)
    adm = cls(rate=rng.choice([None, 2.0, 5.0]), burst=rng.choice([None, 3]),
              max_inflight=rng.choice([None, 1, 2]))
    out, now, held = [], 0.0, []
    for _ in range(60):
        now += rng.random() * 0.3
        tenant = rng.choice(["a", "b", "c"])
        if held and rng.random() < 0.4:
            adm.release(held.pop(rng.randrange(len(held))))
        ok = adm.admit(tenant, now)
        if ok[0]:
            held.append(tenant)
        out.append(ok)
    return out, dict(adm.rejected)


@pytest.mark.parametrize("seed", range(4))
def test_admission_equals_the_jax_packages(seed):
    assert _admissions(AdmissionController, seed) == \
        _admissions(JAdmissionController, seed)


# ---------------------------------------------------------------------
# the gateway over SimBackend
# ---------------------------------------------------------------------
def test_gateway_sse_ordering_and_health():
    cluster, adapters = make_sim_cluster()
    with GatewayHarness(cluster) as h:
        status, health, _ = http_json(h.port, "GET", "/healthz")
        assert status == 200 and health["status"] == "ok"
        status, chunks = sse_request(h.port, {
            "adapter_id": adapters[0].adapter_id, "prompt_len": 16,
            "max_tokens": 10})
        assert status == 200
        assert_in_order(chunks, 10)
        assert chunks[-1]["usage"]["completion_tokens"] == 10
        status, m, _ = http_json(h.port, "GET", "/metrics")
        assert status == 200
        assert "repro_gateway_streamed_tokens_total 10" in m
        assert "repro_cluster_completed_total 1" in m
    assert h.gw.final_report.completed() == 1


def test_gateway_unknown_adapter_404():
    cluster, _ = make_sim_cluster()
    with GatewayHarness(cluster) as h:
        status, body, _ = http_json(h.port, "POST", "/v1/completions",
                                    {"adapter_id": "ghost", "prompt_len": 8})
        assert status == 404 and "ghost" in body["error"]
        assert http_json(h.port, "GET", "/nope")[0] == 404
        assert http_json(h.port, "POST", "/v1/completions",
                         {"prompt_len": 8})[0] == 400
        assert http_json(h.port, "DELETE", "/v1/adapters/ghost")[0] == 404


def test_gateway_runtime_adapter_lifecycle():
    cluster, _ = make_sim_cluster()
    with GatewayHarness(cluster) as h:
        status, created, _ = http_json(h.port, "POST", "/v1/adapters",
                                       {"adapter_id": "live", "rank": 16,
                                        "nbytes": 4 << 20})
        assert status == 201 and created["server"] in (0, 1)
        assert http_json(h.port, "POST", "/v1/adapters",
                         {"adapter_id": "live", "rank": 16})[0] == 409
        _, table, _ = http_json(h.port, "GET", "/v1/adapters")
        entry = {e["adapter_id"]: e for e in table["adapters"]}["live"]
        assert entry["rank"] == 16 and not entry["draining"]
        status, chunks = sse_request(h.port, {"adapter_id": "live",
                                              "prompt_len": 8,
                                              "max_tokens": 5})
        assert status == 200 and len(tokens_of(chunks)) == 5
        status, body, _ = http_json(h.port, "DELETE", "/v1/adapters/live")
        assert status == 202 and body["draining"]
        assert http_json(h.port, "POST", "/v1/completions",
                         {"adapter_id": "live", "prompt_len": 8})[0] == 404
        _wait_gone(h.port, "live", 30)
    rep = h.gw.final_report
    assert rep.registered == 1 and rep.unregistered == 1


def _wait_gone(port, aid, seconds):
    deadline = time.monotonic() + seconds
    while time.monotonic() < deadline:
        _, table, _ = http_json(port, "GET", "/v1/adapters")
        if all(e["adapter_id"] != aid for e in table["adapters"]):
            return
        time.sleep(0.02)
    pytest.fail(f"retired adapter {aid} never left the table")


def test_gateway_admission_fairness_429():
    cluster, adapters = make_sim_cluster()
    admission = AdmissionController(max_inflight=1)
    aid = adapters[0].adapter_id
    with GatewayHarness(cluster, admission=admission) as h:
        started, result = threading.Event(), {}

        def greedy():
            result["out"] = sse_request(
                h.port, {"adapter_id": aid, "prompt_len": 16,
                         "max_tokens": 400}, headers={"x-tenant": "greedy"},
                on_tokens=started.set)

        t = threading.Thread(target=greedy, daemon=True)
        t.start()
        assert started.wait(60), "greedy stream never started"
        status, body, headers = http_json(
            h.port, "POST", "/v1/completions",
            {"adapter_id": aid, "prompt_len": 8, "max_tokens": 2,
             "stream": False}, headers={"x-tenant": "greedy"})
        assert status == 429 and float(headers["retry-after"]) > 0
        assert "max-inflight" in body["error"]
        status, body, _ = http_json(
            h.port, "POST", "/v1/completions",
            {"adapter_id": aid, "prompt_len": 8, "max_tokens": 2,
             "stream": False}, headers={"x-tenant": "polite"})
        assert status == 200 and len(body["tokens"]) == 2
        t.join(300)
        assert not t.is_alive()
        assert len(tokens_of(result["out"][1])) == 400
        assert admission.rejected.get("greedy", 0) >= 1
        assert "polite" not in admission.rejected


def test_gateway_sigterm_drain_zero_lost_tokens_sim():
    cluster, adapters = make_sim_cluster()
    budgets = [60, 80, 100, 120]
    results = [None] * len(budgets)
    h = GatewayHarness(cluster)
    with h:
        def stream(i):
            status, chunks = sse_request(h.port, {
                "adapter_id": adapters[i % len(adapters)].adapter_id,
                "prompt_len": 16, "max_tokens": budgets[i]})
            results[i] = (status, len(tokens_of(chunks)),
                          chunks[-1].get("finish_reason") if chunks else None)

        threads = [threading.Thread(target=stream, args=(i,), daemon=True)
                   for i in range(len(budgets))]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and cluster.pending() < 4:
            time.sleep(0.005)
        assert cluster.pending() == 4
        h.loop.call_soon_threadsafe(h.gw.begin_shutdown)
        assert http_json(h.port, "POST", "/v1/completions", {
            "adapter_id": adapters[0].adapter_id, "prompt_len": 8})[0] == 503
        for t in threads:
            t.join(300)
    for (status, n, reason), budget in zip(results, budgets):
        assert status == 200 and n == budget and reason == "stop"
    rep = h.gw.final_report
    assert rep.completed() == len(budgets) and rep.timed_out == 0
    assert h.gw.state == "stopped"


# ---------------------------------------------------------------------
# the gateway over the port's engines
# ---------------------------------------------------------------------
BASE = (("base-r8", 8), ("busy-r16", 16))


@pytest.fixture(scope="module")
def setup():
    return seeded_setup(dict(BASE))


def _engine_cluster(setup, adapters, *, jax=False):
    """2 engines, max batch 2, no rebalance: the JAX test's cluster, with
    the seeded weights (an adapter registered later gets the port's
    ``registered_weights`` on both sides)."""
    cfg, jp, tp, jw, tw = setup
    common = dict(max_batch=2, max_len=40, seed=0)
    if jax:
        be = JaxSeededBackend(cfg, jp, 2, weights=jw, **common)
        return JCluster(be, [JAdapterInfo(a.adapter_id, a.rank,
                                          nbytes=a.nbytes) for a in adapters],
                        network=JNetworkModel(), rebalance_period=1e9, seed=0)
    be = SeededWeightsBackend(cfg, tp, 2, weights=tw, device="cpu", **common)
    return LoRAServeCluster(be, adapters, network=NetworkModel(),
                            rebalance_period=1e9, seed=0)


def _base_adapters():
    return [AdapterInfo(aid, r, nbytes=r << 20) for aid, r in BASE]


def _register_and_stream(h, prompt):
    """Register ``hot-r8`` over HTTP and stream 6 tokens of ``prompt``."""
    status, _, _ = http_json(h.port, "POST", "/v1/adapters",
                             {"adapter_id": "hot-r8", "rank": 8,
                              "nbytes": 8 << 20})
    assert status == 201
    status, chunks = sse_request(h.port, {"adapter_id": "hot-r8",
                                          "prompt": prompt, "max_tokens": 6})
    assert status == 200
    assert_in_order(chunks, 6)
    return tokens_of(chunks)


def test_engine_register_stream_parity_busy_delete(setup):
    """An adapter registered over HTTP streams the tokens of the port's
    batch ``run`` (the adapter placed from the start) and of the JAX
    gateway; an adapter deleted mid-stream finishes its stream."""
    cfg = setup[0]
    rng = random.Random(11)
    prompt = [rng.randrange(1, cfg.vocab_size) for _ in range(6)]
    hot = AdapterInfo("hot-r8", 8, nbytes=8 << 20)
    ref_req = ServeRequest(req_id=0, adapter_id="hot-r8", rank=8,
                           prompt_len=len(prompt), output_len=6,
                           prompt=list(prompt), arrival=0.0)
    _engine_cluster(setup, _base_adapters() + [hot]).run([ref_req])
    ref = list(ref_req.output)
    assert len(ref) == 6

    with GatewayHarness(_engine_cluster(setup, _base_adapters(), jax=True),
                        gateway_cls=JServeGateway) as h:
        jax_tokens = _register_and_stream(h, prompt)

    cluster = _engine_cluster(setup, _base_adapters())
    with GatewayHarness(cluster) as h:
        assert _register_and_stream(h, prompt) == ref == jax_tokens
        be = cluster.backend
        sid = cluster.orch.placement["hot-r8"]
        assert any(be.hosted_adapters(s).get("hot-r8") == 8 for s in sid)
        # the registered adapter's delta is not 0: its B is seeded
        assert all(float(w["B"].abs().sum()) > 0
                   for w in be.weights["hot-r8"].values())
        # DELETE an adapter while its stream is in flight
        first, result = threading.Event(), {}

        def busy():
            result["out"] = sse_request(
                h.port, {"adapter_id": "busy-r16", "prompt": prompt,
                         "max_tokens": 24}, on_tokens=first.set)

        t = threading.Thread(target=busy, daemon=True)
        t.start()
        assert first.wait(300), "busy stream never started"
        status, body, _ = http_json(h.port, "DELETE",
                                    "/v1/adapters/busy-r16")
        assert status == 202 and body["draining"]
        t.join(600)
        assert not t.is_alive()
        status, chunks = result["out"]
        assert status == 200
        assert_in_order(chunks, 24)
        _wait_gone(h.port, "busy-r16", 60)
    rep = h.gw.final_report
    assert rep.completed() == 2 and rep.timed_out == 0
    assert rep.registered == 1 and rep.unregistered == 1


def test_gateway_sigterm_drain_zero_lost_tokens_engine(setup):
    cfg = setup[0]
    cluster = _engine_cluster(setup, _base_adapters())
    rng = random.Random(2)
    prompts = [[rng.randrange(1, cfg.vocab_size) for _ in range(6)]
               for _ in range(2)]
    budgets = [14, 18]
    results = [None, None]
    h = GatewayHarness(cluster)
    with h:
        def stream(i):
            status, chunks = sse_request(h.port, {
                "adapter_id": BASE[i][0], "prompt": prompts[i],
                "max_tokens": budgets[i]})
            results[i] = (status, chunks)

        threads = [threading.Thread(target=stream, args=(i,), daemon=True)
                   for i in range(2)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline and cluster.pending() < 2:
            time.sleep(0.01)
        assert cluster.pending() == 2
        h.loop.call_soon_threadsafe(h.gw.begin_shutdown)
        assert http_json(h.port, "POST", "/v1/completions", {
            "adapter_id": "base-r8", "prompt_len": 4})[0] == 503
        for t in threads:
            t.join(600)
    for (status, chunks), budget in zip(results, budgets):
        assert status == 200
        assert_in_order(chunks, budget)
    assert h.gw.final_report.completed() == 2
    assert h.gw.state == "stopped"


# ---------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------
def _launch(args, timeout=120):
    """Run ``python -m <args>`` from the repository root, stream one
    request to the gateway it announces, then SIGTERM it. Returns (exit
    code, output, the SSE frames)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    proc = subprocess.Popen([sys.executable, "-m", *args], cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, env=env)
    try:
        line = proc.stdout.readline().strip()
        assert line.startswith("listening on "), line
        port = int(line.rsplit(":", 1)[1])
        status, chunks = sse_request(port, {"adapter_id": "ad0-r8",
                                            "prompt_len": 8,
                                            "max_tokens": 4})
        assert status == 200
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    return proc.returncode, line + "\n" + out, chunks


def test_launch_server_real_sigterm_subprocess():
    rc, out, chunks = _launch(["repro_torch.launch.server", "--device",
                               "cpu", "--config", "smoke", "--port", "0"])
    assert rc == 0, out
    assert_in_order(chunks, 4)
    assert "served=1" in out
    assert out.strip().splitlines()[-1] == "gateway drained OK"


def test_launch_serve_gateway_writes_the_span_trace(tmp_path):
    trace = tmp_path / "t.jsonl"
    rc, out, chunks = _launch([
        "repro_torch.launch.serve", "--serve", "127.0.0.1:0", "--config",
        "smoke", "--device", "cpu", "--dtype", "float32", "--trace-out",
        str(trace), "--flight-recorder", str(tmp_path / "fr")])
    assert rc == 0, out
    assert_in_order(chunks, 4)
    assert "served=1" in out and "gateway drained OK" in out
    assert f"-> {trace}" in out and "costmodel[decode]" in out
    rows = [json.loads(x) for x in trace.read_text().splitlines()]
    names = {r["name"] for r in rows}
    assert {"request", "admission", "gateway.receive", "prefill",
            "decode"} <= names


@pytest.mark.parametrize("main,argv", [
    (launch_server.main, ["--config", "smoke", "--port", "0"]),
    (launch_serve.main, ["--serve", "127.0.0.1:0", "--config", "smoke"])],
    ids=["launch.server", "launch.serve --serve"])
def test_launchers_default_to_the_card(main, argv, monkeypatch):
    """Without a card, the default ``--device cuda`` raises before any
    listener opens; nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(argv)
