"""CLI: ``python -m repro_torch.analysis`` — run the passes over the
port's tree, exit non-zero on any error-severity finding so CI can gate
on it (the JAX package's ``python -m repro.analysis``, its flags and exit
codes).

    python -m repro_torch.analysis                      # all passes
    python -m repro_torch.analysis --format=github      # CI annotations
    python -m repro_torch.analysis --passes=lint,protocol   # no card
    python -m repro_torch.analysis --report=out.json    # findings artifact

The ``smem`` pass reads the card (its limits and the compiled kernels'
resources; it builds the kernel library first); without one it stops
with exit code 2. Warnings (a register spill) are printed but do not
gate; errors do. Exit codes: 0 clean, 1 an error finding, 2 a pass that
cannot run (unknown, or smem without a card).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List

from . import Finding, Severity, format_findings, has_errors

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC_ROOT = os.path.normpath(os.path.join(_HERE, "..", ".."))


class PassUnavailable(Exception):
    """A pass that cannot run here (the smem pass without a card)."""


def run_lint(src_root: str) -> List[Finding]:
    from . import linter
    return linter.lint_tree(os.path.join(src_root, "repro_torch"))


def run_smem(src_root: str) -> List[Finding]:
    import torch

    from . import smem
    if not torch.cuda.is_available():
        raise PassUnavailable(
            "the smem pass reads the card's limits and the compiled "
            "kernels' resources, and torch.cuda.is_available() is False "
            "(run it on the card, or analysis.smem.analyze_kernels with "
            "stated tables)")

    def report(ln, res, limits):
        if not seen:
            print(f"smem: {limits}", file=sys.stderr)
            seen.append(limits)
        share = (ln.dynamic + res.static) / limits.smem_per_block_optin
        print(f"smem[{ln.key} {smem.DTYPES[ln.itemsize]}"
              f"{'' if ln.split is None else f' C={ln.split}'}"
              f"{f' block_t={ln.block_t}' if ln.kid == 'B2' else ''}]: "
              f"threads={ln.threads} min_blocks={ln.min_blocks} "
              f"regs={res.regs} static={res.static} dynamic={ln.dynamic} "
              f"spill={res.local} share={share:.1%} of "
              f"{limits.smem_per_block_optin} B", file=sys.stderr)

    seen = []

    return smem.analyze_kernels(src_root, report=report)


def run_protocol(src_root: str) -> List[Finding]:
    from . import protocol
    pool_py = os.path.join(src_root, "repro_torch", "core", "pool.py")
    findings: List[Finding] = []
    for name, res in protocol.small_model_suite():
        for v in res.violations:
            findings.append(Finding(
                pool_py, 1, f"protocol-{v.invariant}",
                f"[{name}] {v.message}; trace: "
                f"{' -> '.join(v.trace) or '<initial state>'}"))
        if res.truncated:
            findings.append(Finding(
                pool_py, 1, "protocol-truncated",
                f"[{name}] state space truncated at "
                f"{res.states} states — result is bounded, not "
                f"exhaustive", Severity.WARNING))
        print(f"protocol[{name}]: {res.states} states / "
              f"{res.transitions} transitions explored"
              f"{' (truncated)' if res.truncated else ' (exhaustive)'}, "
              f"{len(res.violations)} violation(s)", file=sys.stderr)
    return findings


PASSES = {"lint": run_lint, "smem": run_smem, "protocol": run_protocol}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis")
    ap.add_argument("--format", choices=("text", "github"),
                    default="text")
    ap.add_argument("--passes", default="lint,smem,protocol",
                    help="comma-separated subset of: "
                         + ",".join(PASSES))
    ap.add_argument("--root", default=_SRC_ROOT,
                    help="source root containing the repro_torch package")
    ap.add_argument("--report", default=None,
                    help="write findings as JSON to this path")
    args = ap.parse_args(argv)

    findings: List[Finding] = []
    for name in args.passes.split(","):
        name = name.strip()
        if not name:
            continue
        if name not in PASSES:
            print(f"unknown pass {name!r} (have: "
                  f"{', '.join(PASSES)})", file=sys.stderr)
            return 2
        try:
            findings.extend(PASSES[name](args.root))
        except PassUnavailable as e:
            print(f"pass {name!r} cannot run: {e}", file=sys.stderr)
            return 2

    if findings:
        print(format_findings(findings, args.format))
    errors = [f for f in findings if f.severity is Severity.ERROR]
    warnings = [f for f in findings if f.severity is Severity.WARNING]
    print(f"repro_torch.analysis: {len(errors)} error(s), "
          f"{len(warnings)} warning(s)", file=sys.stderr)
    if args.report:
        with open(args.report, "w", encoding="utf-8") as f:
            json.dump([x.as_dict() for x in findings], f, indent=2)
    return 1 if has_errors(findings) else 0


if __name__ == "__main__":
    sys.exit(main())
