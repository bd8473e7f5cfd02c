"""repro_torch.analysis — static analysis + model checking for the
PyTorch port's tree, the counterpart of the JAX package's
``repro.analysis``.

Three passes, one CLI (``python -m repro_torch.analysis``), exit-code
gated so CI can require it:

* ``linter``   — custom AST lint over ``src/repro_torch`` for eager-torch
  hazards (host<->device syncs on the decode path, per-element syncs in
  host loops, kernel launches whose wrapper never refuses autograd) and
  the JAX linter's Python sharing hazards (mutable default arguments,
  shared-mutable class attributes / dataclass fields, side-effecting
  conditional-expression statements, blocking calls in ``async def``,
  raw logging in library code).
* ``smem``     — the CUDA kernels' shared memory, registers and spills:
  a Python mirror of every kernel's launch geometry (its constants parsed
  from ``kernels/csrc/*.cu``) over the configured (d, d_out, head dim,
  tp, shrink split, block_t, dtype) space, against the card's limits
  (``launch/mesh.py:device_limits``) and, on the card, the compiled
  kernels' own attributes.
* ``protocol`` — the exhaustive-interleaving model checker, driving the
  port's copies of ``AdapterStore`` / ``NetworkModel`` /
  ``RoutingTable`` through fetch / rebalance / drain / retire / crash
  interleavings and asserting the cluster's safety + liveness
  invariants (``core/invariants.py``).

Suppressions: a ``# analysis: ignore[rule]`` comment on the offending
line (or the line directly above it) silences that rule there; a bare
``# analysis: ignore`` silences every rule for the line. Intentional
hits must carry a one-line reason after the marker.

This module is a copy of the JAX package's (findings, severities,
suppressions, formats); it imports nothing but the standard library.
"""
from __future__ import annotations

import dataclasses
import enum
import re
from typing import Dict, List, Optional, Set

IGNORE_RE = re.compile(r"#\s*analysis:\s*ignore(?:\[([a-z0-9_,\- ]+)\])?")

ALL_RULES = "*"


class Severity(enum.Enum):
    ERROR = "error"
    WARNING = "warning"


@dataclasses.dataclass(frozen=True)
class Finding:
    """One analysis result, pointing at a file/line."""
    path: str
    line: int
    rule: str
    message: str
    severity: Severity = Severity.ERROR
    col: int = 0

    def format(self, style: str = "text") -> str:
        if style == "github":
            level = ("error" if self.severity is Severity.ERROR
                     else "warning")
            return (f"::{level} file={self.path},line={self.line},"
                    f"col={self.col},title={self.rule}::{self.message}")
        return (f"{self.path}:{self.line}:{self.col}: "
                f"[{self.rule}] {self.message}")

    def as_dict(self) -> dict:
        return {"path": self.path, "line": self.line, "col": self.col,
                "rule": self.rule, "severity": self.severity.value,
                "message": self.message}


def suppressions(source: str) -> Dict[int, Set[str]]:
    """Map line number (1-based) -> set of suppressed rule names (the
    sentinel ``ALL_RULES`` suppresses everything). A marker on a
    comment-only line also covers the next line, so long findings can
    carry their reason above the code they annotate."""
    out: Dict[int, Set[str]] = {}
    for i, text in enumerate(source.splitlines(), start=1):
        m = IGNORE_RE.search(text)
        if not m:
            continue
        rules = ({r.strip() for r in m.group(1).split(",")}
                 if m.group(1) else {ALL_RULES})
        out.setdefault(i, set()).update(rules)
        if text.lstrip().startswith("#"):       # standalone marker line
            out.setdefault(i + 1, set()).update(rules)
    return out


def apply_suppressions(findings: List[Finding],
                       supp: Dict[int, Set[str]]) -> List[Finding]:
    kept = []
    for f in findings:
        rules = supp.get(f.line, set())
        if ALL_RULES in rules or f.rule in rules:
            continue
        kept.append(f)
    return kept


def format_findings(findings: List[Finding], style: str = "text") -> str:
    return "\n".join(f.format(style) for f in findings)


def has_errors(findings: List[Finding]) -> bool:
    return any(f.severity is Severity.ERROR for f in findings)
