"""AST linter of the PyTorch port: eager-torch host-sync hazards, raw
kernel launches, and the JAX linter's Python sharing hazards (the
counterpart of the JAX package's ``analysis/linter.py``).

Rules (ids used in ``# analysis: ignore[rule]`` markers):

* ``host-sync``        — a host<->device synchronization in a decode-path
  function (a name holding "decode", as the JAX linter's decode-path
  methods): ``.item()``, ``.cpu()``, ``.tolist()``, ``.numpy()`` on
  anything, ``int()`` / ``float()`` / ``bool()`` of a tensor, an ``if``
  or ``while`` on a tensor, ``torch.cuda.synchronize()`` (or any
  ``.synchronize()``), ``np.asarray`` / ``np.array``. Each blocks the
  host until the device's queue drains, and breaks a CUDA graph capture
  of the decode step.
* ``host-sync-loop``   — ``int()`` / ``float()`` / ``bool()`` or
  ``.item()`` of a *subscripted tensor* inside a host ``for`` / ``while``
  loop, anywhere: one blocking transfer per element (``.tolist()`` the
  tensor once before the loop instead).
* ``raw-kernel-launch`` — a call of a kernel library launcher
  (``build.launch("<name>_launch", ...)``, ``_launch(...)`` or
  ``lib.<name>_launch(...)``) in a function that never calls
  ``refuse_autograd``: the kernel writes its output by raw pointer and
  has no backward, so a call under autograd would stop the gradient
  without a word (ROADMAP C17). The counterpart of the JAX
  ``raw-pallas-call``.
* ``mutable-default``, ``shared-mutable-class-attr``,
  ``shared-mutable-dataclass``, ``side-effect-cond``, ``async-blocking``
  and ``raw-log`` — the JAX linter's rules, unchanged (``raw-log``
  exempts the CLI entry points under ``launch/`` and the port's
  ``examples/``: stdout is their interface).

The JAX rule ``traced-if`` has no eager counterpart: an ``if`` on a tensor
runs (it syncs, it does not fail to trace), so it folds into
``host-sync``. No other JAX rule is dropped.

A "tensor" is, heuristically, a name assigned in the same function from
a ``torch.*`` / ``F.*`` call (factories, ops), from a method call on or
a subscript of a tensor name, or from arithmetic on one; assigning a
name from ``.tolist()`` / ``.item()`` / ``.cpu()`` / ``.numpy()`` /
``np.asarray`` makes it a host value again.
"""
from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Set

from . import Finding, Severity, apply_suppressions, suppressions

RULES: Dict[str, str] = {
    "host-sync": "host<->device sync on the decode hot path",
    "host-sync-loop": "per-element device sync inside a host loop",
    "raw-kernel-launch": "kernel launch whose wrapper never refuses "
                         "autograd",
    "mutable-default": "mutable default argument",
    "shared-mutable-class-attr": "class-level mutable attribute shared "
                                 "by all instances",
    "shared-mutable-dataclass": "dataclass field defaulting to a shared "
                                "mutable object",
    "side-effect-cond": "statement-position conditional expression",
    "async-blocking": "blocking call inside an async function stalls "
                      "the event loop",
    "raw-log": "print()/ad-hoc logging call in library code; emit "
               "through the tracer or telemetry instead",
}

# ad-hoc log sinks: `logging.info(...)`, `logger.debug(...)`, etc.
_LOG_LEVEL_METHODS = {"debug", "info", "warning", "warn", "error",
                      "critical", "exception", "log", "basicConfig"}
_LOGGER_NAMES = {"logging", "logger", "log"}

# dotted names whose call blocks the thread — poison inside `async def`
_ASYNC_BLOCKING_CALLS = {
    ("time", "sleep"),
    ("os", "system"),
    ("subprocess", "run"), ("subprocess", "call"),
    ("subprocess", "check_call"), ("subprocess", "check_output"),
    ("socket", "create_connection"), ("socket", "getaddrinfo"),
    ("urllib", "request", "urlopen"),
    ("requests", "get"), ("requests", "post"), ("requests", "put"),
    ("requests", "delete"), ("requests", "head"),
    ("requests", "request"),
}

_MUTABLE_CALLS = {"list", "dict", "set", "defaultdict", "OrderedDict",
                  "deque", "Counter"}
_DECODE_PATH_MARKERS = ("decode",)
# methods whose call copies a tensor to the host (and waits for it)
_SYNC_METHODS = {"item", "cpu", "tolist", "numpy", "synchronize"}
_HOST_ARRAYS = {("np", "asarray"), ("np", "array"), ("numpy", "asarray"),
                ("numpy", "array")}
# torch.* names that return no tensor
_TORCH_NON_TENSOR = {"device", "dtype", "cuda", "distributed", "backends",
                     "is_tensor", "is_grad_enabled", "no_grad",
                     "enable_grad", "inference_mode", "promote_types",
                     "get_default_dtype", "Generator", "Size", "finfo",
                     "iinfo", "manual_seed", "set_num_threads",
                     "get_num_threads", "autograd", "nn", "overrides",
                     "library", "utils", "testing", "multiprocessing"}
_TENSOR_ROOTS = ("torch", "F")


def _dotted(node: ast.AST) -> Optional[tuple]:
    """`a.b.c` -> ("a","b","c"); plain name -> ("a",); else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return tuple(reversed(parts))
    return None



def _is_mutable_default(node: ast.AST) -> bool:
    if isinstance(node, (ast.List, ast.Dict, ast.Set, ast.ListComp,
                         ast.DictComp, ast.SetComp)):
        return True
    if isinstance(node, ast.Call):
        fn = _dotted(node.func)
        return bool(fn) and fn[-1] in _MUTABLE_CALLS and not node.args \
            and not node.keywords or bool(fn) and fn[-1] in _MUTABLE_CALLS
    return False



class Linter(ast.NodeVisitor):
    def __init__(self, path: str, source: str):
        self.path = path
        self.source = source
        self.findings: List[Finding] = []
        self.tree = ast.parse(source, filename=path)
        # stack of {node, decode, tensor_vars, loops}
        self._fn_stack: List[dict] = []
        self._loop_depth = 0
        self._class_stack: List[ast.ClassDef] = []
        # launch/ entry points and the port's examples are CLIs:
        # stdout IS their UI
        norm = "/" + path.replace(os.sep, "/").lstrip("/")
        self._raw_log_exempt = "/launch/" in norm or \
            "/repro_torch/examples/" in norm

    # -- helpers ----------------------------------------------------------
    def _emit(self, node: ast.AST, rule: str, message: str,
              severity: Severity = Severity.ERROR):
        self.findings.append(Finding(
            self.path, getattr(node, "lineno", 0), rule, message,
            severity, getattr(node, "col_offset", 0)))

    def _in_decode_path(self) -> bool:
        return bool(self._fn_stack) and self._fn_stack[-1]["decode"]

    def _in_loop(self) -> bool:
        return self._loop_depth > (self._fn_stack[-1]["loops"]
                                   if self._fn_stack else 0)

    def _tensor_vars(self) -> Set[str]:
        return self._fn_stack[-1]["tensor_vars"] if self._fn_stack \
            else set()

    def _is_host_value(self, node: ast.AST) -> bool:
        """A call that hands the host a copy (``.tolist()``,
        ``np.asarray``, ...): its result is no tensor."""
        if not isinstance(node, ast.Call):
            return False
        if isinstance(node.func, ast.Attribute) and \
                node.func.attr in _SYNC_METHODS:
            return True
        return _dotted(node.func) in _HOST_ARRAYS

    def _is_tensor_expr(self, node: ast.AST) -> bool:
        """Does the expression (heuristically) evaluate to a tensor?"""
        if self._is_host_value(node):
            return False
        if isinstance(node, ast.Name):
            return node.id in self._tensor_vars()
        if isinstance(node, ast.Call):
            f = _dotted(node.func)
            if f and f[0] in _TENSOR_ROOTS and len(f) >= 2:
                return f[1] not in _TORCH_NON_TENSOR
            if isinstance(node.func, ast.Attribute):
                return self._is_tensor_expr(node.func.value)
            return False
        if isinstance(node, ast.Attribute):
            return node.attr == "T" and self._is_tensor_expr(node.value)
        if isinstance(node, ast.Subscript):
            return self._is_tensor_expr(node.value)
        if isinstance(node, ast.BinOp):
            return self._is_tensor_expr(node.left) or \
                self._is_tensor_expr(node.right)
        if isinstance(node, ast.UnaryOp):
            return self._is_tensor_expr(node.operand)
        if isinstance(node, ast.Compare):
            return any(self._is_tensor_expr(x)
                       for x in [node.left] + node.comparators)
        if isinstance(node, ast.BoolOp):
            return any(self._is_tensor_expr(x) for x in node.values)
        return False

    # -- scope tracking ---------------------------------------------------
    def visit_ClassDef(self, node: ast.ClassDef):
        self._class_stack.append(node)
        self._check_class_body(node)
        self.generic_visit(node)
        self._class_stack.pop()

    def _visit_function(self, node):
        decode = any(m in node.name.lower() for m in _DECODE_PATH_MARKERS)
        self._check_defaults(node)
        self._fn_stack.append({"node": node, "decode": decode,
                               "tensor_vars": set(),
                               "loops": self._loop_depth})
        self.generic_visit(node)
        self._fn_stack.pop()

    visit_FunctionDef = _visit_function
    visit_AsyncFunctionDef = _visit_function

    def _visit_loop(self, node):
        self._loop_depth += 1
        self.generic_visit(node)
        self._loop_depth -= 1

    visit_For = _visit_loop

    def visit_While(self, node: ast.While):
        self._check_test(node, "while")
        self._visit_loop(node)

    # -- rules ------------------------------------------------------------
    def _check_defaults(self, fn):
        args = fn.args
        for default in list(args.defaults) + [
                d for d in args.kw_defaults if d is not None]:
            if _is_mutable_default(default):
                self._emit(default, "mutable-default",
                           f"mutable default argument in "
                           f"`{fn.name}()` is shared across calls; use "
                           f"None and create inside")

    def _check_class_body(self, cls: ast.ClassDef):
        is_dataclass = any(
            (_dotted(d) or ())[-1:] == ("dataclass",)
            or (isinstance(d, ast.Call)
                and (_dotted(d.func) or ())[-1:] == ("dataclass",))
            for d in cls.decorator_list)
        for stmt in cls.body:
            if isinstance(stmt, ast.Assign) and not is_dataclass:
                if stmt.targets and isinstance(stmt.targets[0], ast.Name) \
                        and stmt.targets[0].id.startswith("__"):
                    continue        # __slots__ and friends
                if _is_mutable_default(stmt.value):
                    self._emit(stmt, "shared-mutable-class-attr",
                               f"class attribute on `{cls.name}` holds "
                               f"a mutable container shared by every "
                               f"instance; assign it in __init__")
            if isinstance(stmt, ast.AnnAssign) and is_dataclass \
                    and stmt.value is not None:
                self._check_dataclass_field(cls, stmt)

    def _check_dataclass_field(self, cls: ast.ClassDef,
                               stmt: ast.AnnAssign):
        val = stmt.value
        # field(default_factory=...) is the sanctioned form
        if isinstance(val, ast.Call) and \
                (_dotted(val.func) or ())[-1:] == ("field",):
            for kw in val.keywords:
                if kw.arg == "default" and _is_mutable_default(kw.value):
                    self._emit(stmt, "shared-mutable-dataclass",
                               f"dataclass field on `{cls.name}` uses "
                               f"field(default=<mutable>); every "
                               f"instance shares one object — use "
                               f"default_factory")
            return
        if _is_mutable_default(val):
            self._emit(stmt, "shared-mutable-dataclass",
                       f"dataclass field on `{cls.name}` defaults to a "
                       f"mutable literal shared by every instance; use "
                       f"field(default_factory=...)")
            return
        # a bare Name as default for a container-annotated field aliases
        # one module-level object into every instance
        ann = ast.unparse(stmt.annotation) if stmt.annotation else ""
        container = any(t in ann for t in
                        ("List", "Dict", "Set", "list[", "dict[", "set["))
        if container and isinstance(val, ast.Name):
            self._emit(stmt, "shared-mutable-dataclass",
                       f"dataclass field on `{cls.name}` defaults to "
                       f"module-level `{val.id}`; every instance shares "
                       f"that object — use field(default_factory=...)")

    def visit_Assign(self, node: ast.Assign):
        if self._fn_stack:
            tensor = self._is_tensor_expr(node.value)
            for tgt in node.targets:
                names = tgt.elts if isinstance(tgt, ast.Tuple) else [tgt]
                for t in names:
                    if isinstance(t, ast.Name):
                        if tensor:
                            self._tensor_vars().add(t.id)
                        else:
                            self._tensor_vars().discard(t.id)
        self.generic_visit(node)

    def _check_test(self, node, what: str):
        if self._in_decode_path() and self._is_tensor_expr(node.test):
            self._emit(node, "host-sync",
                       f"`{what}` on a tensor copies it to the host and "
                       f"waits for the device; keep the decision on the "
                       f"device (torch.where) or read it once")

    def visit_If(self, node: ast.If):
        self._check_test(node, "if")
        self.generic_visit(node)

    def visit_Expr(self, node: ast.Expr):
        if isinstance(node.value, ast.IfExp):
            self._emit(node, "side-effect-cond",
                       "statement-position conditional expression hides "
                       "a side effect; write the `if` statement out")
        self.generic_visit(node)

    def _in_async(self) -> bool:
        """Directly inside an ``async def`` body (a sync ``def`` nested
        in a coroutine runs wherever it is *called*, so only the
        innermost frame decides)."""
        return bool(self._fn_stack) and isinstance(
            self._fn_stack[-1]["node"], ast.AsyncFunctionDef)

    def _loop_element(self, node: ast.AST) -> bool:
        """A subscript of a tensor inside a host loop."""
        return self._in_loop() and isinstance(node, ast.Subscript) and \
            self._is_tensor_expr(node.value)

    def visit_Call(self, node: ast.Call):
        fn = _dotted(node.func)
        decode = self._in_decode_path()

        if not self._raw_log_exempt and fn is not None:
            if fn == ("print",):
                self._emit(node, "raw-log",
                           "print() in library code bypasses the tracer "
                           "and telemetry; structured paths only")
            elif len(fn) == 2 and fn[0] in _LOGGER_NAMES \
                    and fn[1] in _LOG_LEVEL_METHODS:
                self._emit(node, "raw-log",
                           f"ad-hoc {'.'.join(fn)}() in library code; "
                           f"route through the tracer/telemetry layer")

        if fn in _ASYNC_BLOCKING_CALLS and self._in_async():
            name = self._fn_stack[-1]["node"].name
            self._emit(node, "async-blocking",
                       f"{'.'.join(fn)}() inside `async def {name}` "
                       f"blocks the event loop (pump, SSE streams, and "
                       f"all handlers share it); use the awaitable "
                       f"equivalent or run_in_executor")

        # .item() / .cpu() / .tolist() / .numpy() / .synchronize()
        if isinstance(node.func, ast.Attribute) and \
                node.func.attr in _SYNC_METHODS:
            if node.func.attr == "item" and \
                    self._loop_element(node.func.value):
                self._emit(node, "host-sync-loop",
                           f"{ast.unparse(node.func.value)}.item() inside "
                           f"a host loop issues one blocking transfer per "
                           f"element; .tolist() the tensor once before the "
                           f"loop")
            elif decode:
                self._emit(node, "host-sync",
                           f".{node.func.attr}() on the decode host path "
                           f"waits for the device and copies to the host")

        if fn in _HOST_ARRAYS and decode:
            self._emit(node, "host-sync",
                       f"{'.'.join(fn)} on the decode host path "
                       f"synchronizes the device stream")

        # int() / float() / bool() of a tensor
        if fn in {("float",), ("int",), ("bool",)} and node.args:
            arg = node.args[0]
            if self._loop_element(arg):
                self._emit(node, "host-sync-loop",
                           f"{fn[0]}({ast.unparse(arg)}) inside a host "
                           f"loop issues one blocking transfer per "
                           f"element; .tolist() the tensor once before "
                           f"the loop")
            elif decode and self._is_tensor_expr(arg):
                self._emit(node, "host-sync",
                           f"{fn[0]}() of a tensor on the decode host "
                           f"path waits for the device")

        # a kernel launcher outside a wrapper that refuses autograd
        if self._is_launch(node, fn) and not self._refuses_autograd():
            self._emit(node, "raw-kernel-launch",
                       "kernel launch in a function that never calls "
                       "refuse_autograd: under autograd the kernel's "
                       "output would silently stop the gradient (C17)")
        self.generic_visit(node)

    @staticmethod
    def _is_launch(node: ast.Call, fn) -> bool:
        if isinstance(node.func, ast.Attribute) and \
                node.func.attr.endswith("_launch"):
            return True
        if fn and fn[-1] in ("launch", "_launch") and node.args:
            a = node.args[0]
            return isinstance(a, ast.Constant) and \
                isinstance(a.value, str) and a.value.endswith("_launch")
        return False

    def _refuses_autograd(self) -> bool:
        for frame in reversed(self._fn_stack):
            for sub in ast.walk(frame["node"]):
                if isinstance(sub, ast.Call):
                    f = _dotted(sub.func)
                    if f and f[-1] == "refuse_autograd":
                        return True
        return False


def lint_source(source: str, path: str = "<string>") -> List[Finding]:
    linter = Linter(path, source)
    linter.visit(linter.tree)
    return apply_suppressions(linter.findings, suppressions(source))


def lint_file(path: str) -> List[Finding]:
    with open(path, "r", encoding="utf-8") as f:
        return lint_source(f.read(), path)


def lint_tree(root: str) -> List[Finding]:
    """Lint every ``*.py`` under ``root`` (skipping this package: the
    analyzers legitimately name the hazards they search for)."""
    findings: List[Finding] = []
    skip = os.path.join("repro_torch", "analysis")
    for dirpath, _dirnames, filenames in sorted(os.walk(root)):
        if skip in dirpath:
            continue
        for name in sorted(filenames):
            if name.endswith(".py"):
                findings.extend(lint_file(os.path.join(dirpath, name)))
    return findings
