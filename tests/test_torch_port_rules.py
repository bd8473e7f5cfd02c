"""PyTorch port, package rules: nothing in ``src/repro_torch``,
``chip_smoke.py`` or ``tests/_torch_tp_rank.py`` imports JAX or the JAX
package, and the port's copies of the JAX package's pure-Python modules
have not drifted: each has its original's syntax tree once imports of
``repro`` name ``repro_torch`` (module docstrings aside), apart from the
differences listed here, and the control-plane copies give the
original's outputs on the same seeded inputs."""
import ast
import dataclasses
import random
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
# the port, chip_smoke.py, and the module that tensor-parallel test ranks
# import (they must not import JAX)
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py", ROOT / "tests" / "_torch_tp_rank.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_neither_jax_nor_repro(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_tree_is_scanned():
    names = {p.name for p in PORT_FILES}
    assert {"engine.py", "sgmv.py", "ops.py", "model.py", "bridge.py",
            "mesh.py", "sharding.py", "_torch_tp_rank.py",
            "chip_smoke.py", "backend.py", "cluster.py", "pool.py",
            "orchestrator.py", "network.py", "costmodel.py",
            "telemetry.py", "controller.py", "plan.py",
            "detector.py", "trace.py", "flight.py", "gateway.py",
            "admission.py", "prom.py", "simulator.py", "synth.py",
            "scheduler.py", "server.py", "ssm.py", "paging.py"} <= names
    subpackages = {p.parent.name for p in PORT_FILES}
    assert {"core", "cluster", "controlplane", "faults", "serving",
            "launch", "obs", "server", "traces"} <= subpackages


@pytest.mark.parametrize("getter", ["get_config", "get_smoke_config"])
def test_llama_configs_equal_the_jax_package(getter):
    import repro.configs as jcfg
    import repro_torch.configs as tcfg
    a = dataclasses.asdict(getattr(jcfg, getter)("llama-7b-paper"))
    b = dataclasses.asdict(getattr(tcfg, getter)("llama-7b-paper"))
    assert a == b


@pytest.mark.parametrize("getter", ["get_config", "get_smoke_config"])
@pytest.mark.parametrize("arch", [
    "qwen2.5-32b", "codeqwen1.5-7b", "internlm2-1.8b", "stablelm-1.6b",
    "deepseek-v2-lite-16b", "llama4-scout-17b-a16e", "zamba2-7b",
    "rwkv6-7b"])
def test_registered_configs_equal_the_jax_package(arch, getter):
    import repro.configs as jcfg
    import repro_torch.configs as tcfg
    assert arch in tcfg.ARCH_IDS
    a = dataclasses.asdict(getattr(jcfg, getter)(arch))
    b = dataclasses.asdict(getattr(tcfg, getter)(arch))
    assert a == b


def test_request_and_metrics_copies_match():
    """The copied request type and metrics collector behave as the JAX
    package's on the same lifecycle."""
    from repro.core.request import Request as JReq
    from repro.serving.metrics import MetricsCollector as JMC
    from repro_torch.core.request import Request as TReq
    from repro_torch.serving.metrics import MetricsCollector as TMC
    sums = []
    for Req, MC in ((JReq, JMC), (TReq, TMC)):
        mc = MC()
        for i in range(5):
            r = Req(i, "a", [1, 2, 3], 4, arrival=0.5 * i)
            r.t_first_token, r.t_finish = 1.0 + i, 2.0 + 1.5 * i
            r.output = [7] * (1 + i % 3)
            mc.record(r)
        sums.append(mc.summary())
    assert sums[0].keys() == sums[1].keys()
    for k in sums[0]:
        assert sums[0][k] == pytest.approx(sums[1][k], nan_ok=True)


# ---------------------------------------------------------------------------
# copies of the JAX package's pure-Python modules
# ---------------------------------------------------------------------------
SRC = ROOT / "src"
# port file[:definition] -> (original, the definition compared or None for
# the module)
COPIES = {f: (f, None) for f in (
    "core/types.py", "core/routing.py", "core/placement.py",
    "core/baselines.py", "core/demand.py", "core/pool.py",
    "core/orchestrator.py", "cluster/network.py", "cluster/costmodel.py",
    "controlplane/__init__.py", "controlplane/telemetry.py",
    "controlplane/slo.py", "controlplane/drift.py",
    "controlplane/controller.py", "faults/__init__.py", "faults/plan.py",
    "faults/injector.py", "faults/detector.py", "faults/recovery.py",
    "serving/cluster.py", "obs/__init__.py", "obs/trace.py",
    "obs/export.py", "obs/flight.py", "obs/drift.py",
    "server/__init__.py", "server/admission.py", "server/http.py",
    "server/prom.py", "server/gateway.py", "cluster/__init__.py",
    "cluster/server.py", "cluster/simulator.py", "traces/__init__.py",
    "traces/synth.py", "traces/production.py", "serving/scheduler.py",
    "serving/request.py", "configs/base.py", "configs/llama_7b_paper.py",
    "configs/qwen2_5_32b.py", "configs/codeqwen1_5_7b.py",
    "configs/internlm2_1_8b.py", "configs/stablelm_1_6b.py",
    "configs/deepseek_v2_lite_16b.py", "configs/llama4_scout_17b_16e.py",
    "configs/zamba2_7b.py", "configs/rwkv6_7b.py",
    "configs/llama_3_2_vision_90b.py", "configs/seamless_m4t_large_v2.py",
    "serving/paging.py", "data/__init__.py", "data/pipeline.py",
    "launch/report.py", "analysis/__init__.py", "analysis/protocol.py")}
COPIES["core/invariants.py"] = ("analysis/protocol.py",
                                "check_store_invariants")
COPIES["serving/backend.py"] = ("serving/backend.py", "ServingBackend")
COPIES["serving/backend.py:SimBackend"] = ("serving/backend.py",
                                           "SimBackend")


def _tree(path, name):
    """``path``'s syntax tree, imports of ``repro`` renamed ``repro_torch``
    and the module docstring dropped; or the definition ``name`` in it."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.level == 0 and \
                node.module.split(".")[0] == "repro":
            node.module = "repro_torch" + node.module[len("repro"):]
    body = tree.body
    if isinstance(body[0], ast.Expr) and isinstance(body[0].value,
                                                    ast.Constant):
        tree.body = body[1:]
    if name is None:
        return tree
    defs = [n for n in tree.body if getattr(n, "name", None) == name]
    assert len(defs) == 1, (path, name)
    return defs[0]


def _method(tree, cls, name):
    c = next(n for n in tree.body if getattr(n, "name", None) == cls)
    return next(n for n in c.body if getattr(n, "name", None) == name)


def _invariants_import(orig, port):
    """``core/pool.py``: the invariant sweep comes from the port's copy
    (``core/invariants.py``), not from the JAX package's analysis
    suite."""
    for node in ast.walk(_method(orig, "AdapterStore", "check_invariants")):
        if isinstance(node, ast.ImportFrom):
            assert node.module == "repro_torch.analysis.protocol"
            node.module, node.level = "invariants", 1


def _invariants_from_core(orig, port):
    """``analysis/protocol.py``: the shared invariants are the port's one
    copy, ``core/invariants.py``, imported in place of the definition."""
    body = [n for n in orig.body
            if getattr(n, "name", None) != "check_store_invariants"]
    at = next(i for i, n in enumerate(body) if isinstance(n, ast.ImportFrom)
              and n.module == "typing") + 1
    body.insert(at, ast.ImportFrom(
        module="repro_torch.core.invariants",
        names=[ast.alias(name="check_store_invariants")], level=0))
    orig.body[:] = body


INTENDED = {"core/pool.py": _invariants_import,
            "analysis/protocol.py": _invariants_from_core}


@pytest.mark.parametrize("port_file", sorted(COPIES))
def test_copied_module_has_the_originals_syntax_tree(port_file):
    orig_file, name = COPIES[port_file]
    orig = _tree(SRC / "repro" / orig_file, name)
    port = _tree(SRC / "repro_torch" / port_file.split(":")[0], name)
    if port_file in INTENDED:
        INTENDED[port_file](orig, port)
    assert ast.dump(port) == ast.dump(orig)


def test_core_exports_the_jax_packages_names():
    import repro.core as jcore
    import repro_torch.core as tcore
    assert set(tcore.__all__) == set(jcore.__all__)
    for name in tcore.__all__:
        getattr(tcore, name)


@pytest.mark.parametrize("pkg", ["cluster", "obs", "server", "traces"])
def test_copied_packages_export_the_jax_packages_names(pkg):
    import importlib
    jmod = importlib.import_module(f"repro.{pkg}")
    tmod = importlib.import_module(f"repro_torch.{pkg}")
    names = getattr(jmod, "__all__", None) or [
        n for n in dir(jmod) if not n.startswith("_")]
    for name in names:
        assert hasattr(tmod, name), name


def test_serving_exports_the_jax_packages_names_but_paging():
    import repro.serving as jserving
    import repro_torch.serving as tserving
    # every name, the unified page pool's too (it was left out until it
    # was ported); submodule names appear in dir() once any test has
    # imported them
    want = {n for n in dir(jserving) if not n.startswith("_")} - {
        "paging", "backend", "cluster", "engine", "metrics", "request",
        "scheduler", "sharding"}
    assert want <= set(tserving.__all__), want - set(tserving.__all__)


def _placement_case(pkg, seed):
    """``assign_loraserve`` twice (the second from the first's placement,
    with shifted demand) on seeded adapters."""
    rng = random.Random(seed)
    ops = {8: 4000.0, 16: 3900.0, 32: 3700.0, 64: 3400.0, 128: 2900.0}
    adapters = [pkg.AdapterInfo(f"a{i}", rng.choice(sorted(ops)))
                for i in range(rng.randrange(4, 30))]
    n = rng.randrange(2, 6)
    out, prev = [], None
    for _ in range(2):
        demand = {a.adapter_id: rng.uniform(0.0, 3000.0) for a in adapters}
        prev, stats = pkg.assign_loraserve(pkg.PlacementContext(
            n_servers=n, adapters=adapters, demand_tps=demand,
            operating_points=ops, prev_placement=prev))
        out.append((prev, dataclasses.asdict(stats)))
    return out


def _routing_case(pkg, seed):
    """A seeded routing table: routes, a blocked and unblocked server, the
    per-adapter counts."""
    rng = random.Random(seed)
    placement = {}
    for i in range(6):
        servers = rng.sample(range(4), rng.randrange(1, 4))
        if servers == [1]:       # server 1 is blocked below
            servers.append(0)
        w = [rng.random() + 0.1 for _ in servers]
        placement[f"a{i}"] = {s: x / sum(w) for s, x in zip(servers, w)}
    table = pkg.RoutingTable(placement, seed=seed)
    routes = [table.route_detailed(f"a{rng.randrange(6)}", rng.random())
              for _ in range(50)]
    table.block_server(1)
    routes += [table.route(f"a{i}") for i in range(6)]
    table.unblock_server(1)
    return routes, table.reset_counts()


def _pool_case(pkg, net, seed):
    """A seeded adapter store: seed, a new placement, fetches, remote
    reads, polls, a failed server; its state and counters after each."""
    rng = random.Random(seed)
    adapters = [pkg.AdapterInfo(f"a{i}", 8 << (i % 5),
                                nbytes=rng.randrange(1, 400) * 1_000_000)
                for i in range(8)]
    store = pkg.AdapterStore(4, adapters, net.NetworkModel())
    store.seed({a.adapter_id: {i % 4: 1.0} for i, a in enumerate(adapters)})
    store.apply_placement({a.adapter_id: {(i + 1) % 4: 0.5, i % 4: 0.5}
                           for i, a in enumerate(adapters)}, now=0.0)
    plans, now = [], 0.0
    for _ in range(20):
        now += rng.random() * 0.05
        aid, sid = f"a{rng.randrange(8)}", rng.randrange(4)
        p = (store.start_fetch(sid, aid, now=now) if rng.random() < 0.5
             else store.plan_access(sid, aid, now=now,
                                    access_mode="remote-read"))
        plans.append(dataclasses.asdict(p))
        plans += [dataclasses.asdict(q) for q in store.poll(now)]
    orphans = store.fail_server(2, now=now)
    plans += [dataclasses.asdict(q) for q in store.poll(now + 10.0)]
    state = ({s: sorted(v) for s, v in enumerate(store.local)},
             {a: sorted(v) for a, v in store.index.items()},
             store.fetches, store.remote_reads, store.coalesced,
             store.total_bytes())
    return plans, sorted(orphans), state, store.check_invariants(now + 10.0)


@pytest.mark.parametrize("seed", range(4))
def test_control_plane_copies_give_the_originals_outputs(seed):
    import repro.cluster.network as jnet
    import repro.core as jcore
    import repro_torch.cluster.network as tnet
    import repro_torch.core as tcore
    assert _placement_case(tcore, seed) == _placement_case(jcore, seed)
    assert _routing_case(tcore, seed) == _routing_case(jcore, seed)
    assert _pool_case(tcore, tnet, seed) == _pool_case(jcore, jnet, seed)


def _device_defaults():
    """(module, function, the default of its ``device`` parameter, or None
    where the caller must pass one) of every public function of the
    port with a ``device`` parameter: module-level functions and the
    methods (``__init__`` among them) of module-level classes, neither
    named with a leading underscore."""
    out = []
    for path in sorted((ROOT / "src" / "repro_torch").rglob("*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        defs = [(n, n.name) for n in tree.body
                if isinstance(n, ast.FunctionDef)]
        for c in tree.body:
            if isinstance(c, ast.ClassDef) and not c.name.startswith("_"):
                defs += [(n, f"{c.name}.{n.name}") for n in c.body
                         if isinstance(n, ast.FunctionDef)
                         and (n.name == "__init__"
                              or not n.name.startswith("_"))]
        for fn, name in defs:
            if name.split(".")[-1].startswith("_") and \
                    not name.endswith("__init__"):
                continue
            a = fn.args
            pos = a.posonlyargs + a.args
            pairs = list(zip(pos[len(pos) - len(a.defaults):], a.defaults))
            pairs += list(zip(a.kwonlyargs, a.kw_defaults))
            pairs += [(x, None) for x in pos[:len(pos) - len(a.defaults)]]
            for arg, default in pairs:
                if arg.arg == "device":
                    out.append((str(path.relative_to(ROOT)), name,
                                None if default is None
                                else ast.literal_eval(default)))
    return out


def test_every_device_parameter_defaults_to_the_card():
    """The port's device rule (``repro_torch/device.py``): an entry point
    runs on the card unless its caller asks for the CPU, so every public
    function that takes a ``device`` defaults to ``"cuda"`` (or makes the
    caller pass one); none defaults to the CPU."""
    found = _device_defaults()
    names = {name for _, name, _ in found}
    assert {"init_params", "init_cache", "mamba2_state", "rwkv6_state",
            "ServingEngine.__init__", "EngineBackend.__init__",
            "make_engine_mesh", "build_bank"} <= names, names
    bad = [f for f in found if f[2] not in (None, "cuda")]
    assert not bad, bad
