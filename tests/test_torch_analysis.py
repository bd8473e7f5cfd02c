"""PyTorch port, ``repro_torch.analysis`` against the JAX package's
``repro.analysis``:

* the linter's torch rules (``host-sync`` on the decode path,
  ``host-sync-loop``, ``raw-kernel-launch``), each with a fixture that
  must trigger and one that must not; the rules copied from the JAX
  linter give the JAX linter's (line, rule) findings on every fixture
  snippet of the JAX package's own ``tests/test_analysis.py``;
  suppressions are scoped by rule; the port's tree is lint-clean; the
  CLI's exit codes, its github format and its report;
* the protocol model checker: ``small_model_suite()`` explores the same
  states and transitions, finds the same violations and truncates the
  same models as the JAX suite (run in a subprocess beside it), and
  re-finds the GC-vs-fetch race on a store without the guard;
* the shared-memory pass: the mirror's constants are the ``.cu`` text's,
  the production envelope fits the H100's limits as stated here (its
  data: 227 KB a block, 228 KB and 64 K registers an SM, 1 KB reserved
  a block, clusters of 16), and an inflated geometry, a tiny budget, a
  mirror that disagrees with stated attributes, a spill, a register
  bust, a cluster the card cannot hold and a missing constant each give
  their finding. The card's own reading is ``chip_smoke.py``'s.
"""
import ast
import json
import os
import subprocess
import sys
import textwrap

import pytest

from repro.analysis.linter import lint_source as jax_lint_source
from repro_torch.analysis import (ALL_RULES, Finding, Severity, has_errors,
                                  suppressions)
from repro_torch.analysis import protocol, smem
from repro_torch.analysis.__main__ import main as analysis_main
from repro_torch.analysis.linter import lint_source, lint_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
COPIED_RULES = {"mutable-default", "shared-mutable-class-attr",
                "shared-mutable-dataclass", "side-effect-cond",
                "async-blocking", "raw-log"}


def _rules(src):
    return [f.rule for f in lint_source(textwrap.dedent(src))]


# --------------------------------------------------------------------------
# the torch rules: each triggers on one fixture and not on another
# --------------------------------------------------------------------------

@pytest.mark.parametrize("body", [
    "return x.item()",
    "return self.last_token.tolist()",
    "return x.cpu()",
    "return x.float().numpy()",
    "torch.cuda.synchronize()",
    "torch.cuda.current_stream().synchronize()",
    "return np.asarray(x)",
])
def test_host_sync_on_the_decode_path(body):
    assert "host-sync" in _rules(f"""
        class Engine:
            def _decode_once(self, x):
                {body}
        """)


def test_host_sync_on_a_tensors_value_in_decode():
    assert _rules("""
        def decode_steps(logits):
            tok = torch.argmax(logits, dim=-1)
            n = int(tok)
            m = float(tok.max())
            if tok > 0:
                return n
            while tok.sum() > 0:
                break
            return bool(tok == 1) and m
        """).count("host-sync") == 5


def test_no_host_sync_off_the_decode_path_or_on_host_values():
    assert _rules("""
        def summarize(x):
            y = torch.relu(x)
            return x.item(), y.tolist(), int(y), float(x.cpu())
        """) == []
    assert _rules("""
        def decode_steps(self, k, host):
            n = int(k)
            m = int(host[0]) + len(self.slots)
            if len(host) > n and host[0] > m:
                return float(host[0])
            return bool(self.eos)
        """) == []


def test_host_sync_loop_per_element():
    rules = _rules("""
        def step(batch):
            toks = torch.argmax(batch, dim=-1)
            out = []
            for i in range(4):
                out.append(int(toks[i]))
                out.append(toks[i].item())
            return out
        """)
    assert rules == ["host-sync-loop", "host-sync-loop"]


def test_host_sync_loop_quiet_after_materialize():
    assert _rules("""
        def step(batch):
            toks = torch.argmax(batch, dim=-1)
            toks_host = toks.tolist()
            out = []
            for i in range(4):
                out.append(int(toks_host[i]))
            return out
        """) == []


@pytest.mark.parametrize("call", [
    '_launch("sgmv_shrink_launch", x.device, x.data_ptr())',
    'build.launch("flash_mha_launch", x.device, 0)',
    'load_library().sgmv_expand_launch(0, x.data_ptr())'])
def test_raw_kernel_launch_without_refuse_autograd(call):
    assert "raw-kernel-launch" in _rules(f"""
        def wrapper(x):
            out = torch.empty_like(x)
            {call}
            return out
        """)
    assert _rules(f"""
        def wrapper(x):
            refuse_autograd("wrapper", x)
            out = torch.empty_like(x)
            {call}
            return out
        """) == []


def test_launch_of_another_kind_is_not_a_kernel_launch():
    assert _rules("""
        def start(pool, x):
            pool.launch(x)
            return launch("worker", x)
        """) == []


# --------------------------------------------------------------------------
# the copied rules: the JAX linter's findings on its own fixtures
# --------------------------------------------------------------------------

def _jax_fixture_snippets():
    """Every source string the JAX package's ``tests/test_analysis.py``
    lints: the literals passed to its ``_rules`` and ``textwrap.dedent``,
    with the paths it lints them at."""
    path = os.path.join(REPO, "tests", "test_analysis.py")
    tree = ast.parse(open(path, encoding="utf-8").read())
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                "_rules", "dedent") and node.args and isinstance(
                node.args[0], ast.Constant) and isinstance(
                node.args[0].value, str):
            out.append(textwrap.dedent(node.args[0].value))
    assert len(out) >= 25, len(out)
    return out


@pytest.mark.parametrize("path", ["<string>", "src/repro/launch/serve.py",
                                  "src/repro/serving/cluster.py"])
def test_copied_rules_find_what_the_jax_linter_finds(path):
    for src in _jax_fixture_snippets():
        want = [(f.line, f.rule) for f in jax_lint_source(src, path)
                if f.rule in COPIED_RULES]
        got = [(f.line, f.rule) for f in lint_source(src, path)
               if f.rule in COPIED_RULES]
        assert got == want, src


def test_raw_log_exempts_the_ports_cli_entry_points():
    src = "def main():\n    print('served OK')\n"
    for path in ("src/repro_torch/launch/serve.py",
                 "src/repro_torch/examples/quickstart.py"):
        assert lint_source(src, path) == []
    assert [f.rule for f in lint_source(
        src, "src/repro_torch/serving/engine.py")] == ["raw-log"]


def test_suppression_is_rule_scoped():
    decode = """
        def decode_steps(x):
            return x.tolist()  # analysis: ignore[{}]
        """
    assert "host-sync" in _rules(decode.format("raw-log"))
    assert _rules(decode.format("host-sync")) == []
    assert _rules("""
        def decode_steps(x):
            # analysis: ignore[host-sync] the one sync per k tokens
            return x.tolist()
        """) == []
    supp = suppressions("a = 1  # analysis: ignore[r1, r2]\n"
                        "# analysis: ignore\nb = 2\n")
    assert supp[1] == {"r1", "r2"}
    assert ALL_RULES in supp[2] and ALL_RULES in supp[3]


def test_port_tree_is_lint_clean():
    findings = lint_tree(os.path.join(SRC, "repro_torch"))
    assert findings == [], "\n".join(f.format() for f in findings)


def test_the_engines_syncs_carry_their_markers():
    """The engine's decode syncs are the ones the rule finds; each carries
    a marker with its reason (ROADMAP A1 lists them for the graph
    capture)."""
    path = os.path.join(SRC, "repro_torch", "serving", "engine.py")
    source = open(path, encoding="utf-8").read()
    from repro_torch.analysis import linter
    raw = linter.Linter(path, source)
    raw.visit(raw.tree)
    lines = sorted(f.line for f in raw.findings if f.rule == "host-sync")
    assert len(lines) == 2
    text = source.splitlines()
    for n in lines:
        assert "analysis: ignore[host-sync]" in text[n - 2]
        assert ".tolist()" in text[n - 1]


# --------------------------------------------------------------------------
# CLI: exit codes, formats, report
# --------------------------------------------------------------------------

def test_cli_lint_clean_tree_exits_zero(capsys):
    assert analysis_main(["--passes=lint", "--root", SRC]) == 0


def test_cli_exits_nonzero_on_seeded_fixture(tmp_path, capsys):
    pkg = tmp_path / "repro_torch"
    pkg.mkdir()
    (pkg / "bad.py").write_text(
        "def f(a, acc=[]):\n    return acc\n\n\n"
        "def decode_steps(x):\n    return x.item()\n")
    report = tmp_path / "findings.json"
    rc = analysis_main(["--passes=lint", "--root", str(tmp_path),
                        "--report", str(report), "--format=github"])
    assert rc == 1
    out = capsys.readouterr().out
    assert "::error" in out and "mutable-default" in out
    data = json.loads(report.read_text())
    assert [d["rule"] for d in data] == ["mutable-default", "host-sync"]


def test_cli_refuses_unknown_pass_and_smem_without_a_card(capsys):
    assert analysis_main(["--passes=nope"]) == 2
    assert analysis_main(["--passes=smem"]) == 2
    assert "torch.cuda.is_available() is False" in capsys.readouterr().err


def test_finding_github_format():
    f = Finding("a.py", 3, "r", "msg", Severity.WARNING, col=7)
    assert f.format("github") == \
        "::warning file=a.py,line=3,col=7,title=r::msg"
    assert f.format() == "a.py:3:7: [r] msg"
    assert not has_errors([f])


# --------------------------------------------------------------------------
# protocol: the port's suite against the JAX suite; the race re-found
# --------------------------------------------------------------------------

JAX_SUITE = """
import json
from repro.analysis import protocol
print(json.dumps([[name, r.states, r.transitions, r.truncated,
                   [[v.invariant, v.message, list(v.trace)]
                    for v in r.violations]]
                  for name, r in protocol.small_model_suite()]))
"""


def test_protocol_suite_equals_the_jax_suite():
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", JAX_SUITE],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)
    try:
        ours = [[name, r.states, r.transitions, r.truncated,
                 [[v.invariant, v.message, list(v.trace)]
                  for v in r.violations]]
                for name, r in protocol.small_model_suite()]
        out, err = proc.communicate(timeout=300)
    finally:
        proc.kill()
    assert proc.returncode == 0, err
    assert ours == json.loads(out)
    assert [x[0] for x in ours] == ["fetch-gc", "drain-retire",
                                    "crash-recovery"]
    assert all(x[1] > 50 and not x[4] for x in ours)
    assert [x[3] for x in ours] == [False, False, True]


def test_protocol_refinds_the_gc_race_without_guard():
    from repro_torch.core.pool import AdapterStore

    class Unguarded(AdapterStore):
        """The pre-fix _gc: evicts without consulting in-flight plans."""

        def _gc(self, adapter_id):
            inflight, self._inflight = self._inflight, {}
            try:
                super()._gc(adapter_id)
            finally:
                self._inflight = inflight

    res = protocol.check_model(
        protocol.fetch_gc_model(store_cls=Unguarded, max_depth=5))
    races = [v for v in res.violations
             if v.invariant == "inflight-src-resident"]
    assert races and any("GC-vs-fetch race" in v.message for v in races)
    assert min(len(v.trace) for v in races) <= 5


def test_protocol_invariants_are_the_ports_one_copy():
    from repro_torch.core import invariants
    assert protocol.check_store_invariants is \
        invariants.check_store_invariants
    w = protocol.World(protocol.fetch_gc_model())
    assert w.invariant_errors() == []
    w.store.local[0].discard("a0")
    assert any(e.startswith("index-consistent")
               for e in w.invariant_errors())


# --------------------------------------------------------------------------
# smem: the mirror, the envelope, the rules
# --------------------------------------------------------------------------

# The H100 SXM's limits, stated (the card's own come from device_limits)
H100 = dict(smem_per_block_optin=232448, smem_per_sm=233472,
            smem_reserved_per_block=1024, regs_per_sm=65536,
            regs_per_block=65536, threads_per_sm=2048, max_cluster=16)


def _sources():
    return (smem._read(SRC, smem.SGMV_CU), smem._read(SRC, smem.FLASH_CU))


def _launches(sgmv=None, flash=None):
    sg, fl = _sources()
    consts, found = smem.parse_constants(sgmv or sg, flash or fl)
    assert consts is not None, found
    return smem.kernel_launches(consts, *smem.config_space())


def _check(launches, limits=H100, attrs=None, occ=None):
    out = []
    for ln in launches:
        out += smem.check_launch(ln, limits, (attrs or {}).get(ln),
                                 (occ or {}).get(ln))
    return out


def test_mirror_constants_are_the_sources():
    sg, fl = _sources()
    consts, found = smem.parse_constants(sg, fl)
    assert found == []
    for name, value in consts.sgmv.items():
        if name in smem._SGMV_NAMES:
            assert f"constexpr int {name} = {value};" in sg
    for name in ("kTcThreads", "kTcRows", "kTcKeys", "kRowPad", "kTile",
                 "kF32Keys", "kF32WideKeys", "kF32Pad", "kF32VPad"):
        assert f"constexpr int {name} = {consts.flash[name]};" in fl
    assert "constexpr int kPad = sizeof(T) == 2 ? " \
        f"{consts.pad[2]} : {consts.pad[4]};" in sg
    assert "constexpr int kFusedMinBlocks = sizeof(T) == 2 ? " \
        f"{consts.fused_min_blocks[2]} : {consts.fused_min_blocks[4]};" \
        in sg
    assert "using GeoFused = Geo<T, 16, 4, 256, 32>;" in sg
    assert consts.geos["GeoFused"] == {2: (16, 4, 256, 32),
                                       4: (16, 4, 256, 32)}
    assert consts.geos["GeoBank"] == {2: (16, 3, 256, 64),
                                      4: (16, 2, 256, 64)}
    assert consts.geos["GeoWide"] == {2: (64, 2, 128, 64),
                                      4: (64, 2, 128, 32)}
    assert consts.bounds == {
        "sgmv_fused_blocks_kernel": ("kThreads", "kFusedMinBlocks<T>"),
        "sgmv_multibank_blocks_kernel": ("kThreads", "2"),
        "sgmv_shrink_kernel": ("kThreads", "1"),
        "sgmv_expand_kernel": ("kTileThreads", "1"),
        "sgmv_multibank_shrink_kernel": ("kThreads", "2"),
        "sgmv_multibank_expand_kernel": ("kTileThreads", "1"),
        "flash_mha_kernel": ("kTcThreads", "2"),
        "flash_mha_bf16_kernel": ("kTcThreads", "1")}


def test_the_envelope_covers_every_kernel_split_and_type():
    launches = _launches()
    assert {ln.kid for ln in launches} == {"B1", "B2", "B3a", "B3b", "B4a",
                                           "B4b", "B5"}
    for size in (2, 4):
        assert {ln.split for ln in launches if ln.kid == "B1"
                and ln.itemsize == size} == {4, 8, 16}
    assert {ln.block_t for ln in launches if ln.kid == "B2"} == {16, 32, 64}
    for kernel in ("flash_mha_kernel", "flash_mha_bf16_kernel"):
        assert {ln.hd for ln in launches if ln.kernel == kernel} == {64, 128}
    b5 = {ln.hd: ln for ln in launches if ln.kernel == "flash_mha_kernel"}
    # q, two k and two v tiles: 64 keys at HDP 64, 32 at HDP 128
    assert b5[64].dynamic == 4 * (192 * 80 + 128 * 68) == 96256
    assert b5[128].dynamic == 4 * (128 * 144 + 64 * 132) == 107520
    assert (b5[128].threads, b5[128].min_blocks) == (128, 2)
    b1 = next(ln for ln in launches if ln.kid == "B1" and ln.itemsize == 2
              and ln.split == 16)
    assert (b1.threads, b1.min_blocks, b1.dynamic) == (256, 3, 47872)


def test_production_envelope_fits_the_h100():
    findings = smem.analyze_kernels(SRC, limits=H100)
    assert findings == [], "\n".join(f.format() for f in findings)


def test_inflated_geometry_fails():
    sg, _ = _sources()
    needle = "using GeoWide = Geo<T, 64, 2, 128,"
    assert needle in sg, "B2's wide geometry moved; update the test"
    launches = _launches(sgmv=sg.replace(needle,
                                         "using GeoWide = Geo<T, 64, 8, 128,"))
    findings = _check(launches)
    assert {f.rule for f in findings} == {"smem-budget", "smem-occupancy"}
    assert all("GeoWide" in f.message for f in findings)
    assert has_errors(findings)
    # three slots: over the SM at 2 blocks, not over a block
    findings = _check(_launches(sgmv=sg.replace(
        needle, "using GeoWide = Geo<T, 64, 3, 128,")))
    assert {f.rule for f in findings} == {"smem-occupancy"}


def test_tiny_budget_fails():
    findings = _check(_launches(), dict(H100, smem_per_block_optin=32 << 10))
    assert {f.rule for f in findings} == {"smem-budget"}
    assert any("flash_mha_kernel" in f.message for f in findings)
    assert any("float32" in f.message for f in findings)


def test_stated_attributes_mirror_spill_registers_clusters():
    launches = _launches()
    b1 = next(ln for ln in launches if ln.kid == "B1" and ln.itemsize == 2)
    b3b = next(ln for ln in launches if ln.kid == "B3b")
    ok = {b1: smem.Resources(80, 0, 0, 256, b1.dynamic),
          b3b: smem.Resources(96, b3b.static, 0, 128, 0)}
    assert _check([b1, b3b], attrs=ok, occ={b1: 4}) == []
    rules = {f.rule for f in _check([b1, b3b], attrs={
        b1: smem.Resources(80, 0, 0, 256, b1.dynamic + 16),
        b3b: smem.Resources(96, b3b.static + 4, 0, 128, 0)})}
    assert rules == {"smem-mirror"}
    spill = _check([b1], attrs={b1: smem.Resources(80, 0, 24, 256,
                                                   b1.dynamic)})
    assert [(f.rule, f.severity) for f in spill] == [("reg-spill",
                                                      Severity.WARNING)]
    assert [f.rule for f in _check([b1], attrs={b1: smem.Resources(
        128, 0, 0, 256, b1.dynamic)})] == ["smem-occupancy"]
    assert [f.rule for f in _check([b1], occ={b1: 0})] == ["cluster-size"]
    c16 = next(ln for ln in launches if ln.kid == "B1" and ln.split == 16)
    assert [f.rule for f in _check([c16], dict(H100, max_cluster=8))] == \
        ["cluster-size"]


def test_missing_constant_is_a_parse_finding():
    sg, fl = _sources()
    consts, found = smem.parse_constants(
        sg.replace("constexpr int kTileThreads = ", "int kTileThreads = "),
        fl)
    assert consts is None
    assert [f.rule for f in found] == ["smem-parse"]
    assert "kTileThreads" in found[0].message
