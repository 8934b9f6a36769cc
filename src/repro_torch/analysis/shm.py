"""Rule family SHM: the dynamic shared memory of the CUDA launches.

A kernel's dynamic shared-memory byte count is worked out by its
wrapper's ``launch_shape`` or ``launch_plan`` and passed to the launch;
the card refuses a block past ``_build.MAX_SHARED_BYTES``, and a count
smaller than the kernel's layout lets the kernel write past its buffer.
So a byte count is made in one place, and checked there.

- ``SHM001`` *a byte count from elsewhere*: a launch in ``kernels/``
  passes a shared-memory byte count (an argument named ``*shared*`` or
  ``*smem*``) that is not bound from a ``launch_shape``/``launch_plan``
  call in the launching function (``x = launch_plan(...)``,
  ``a, b, x = launch_shape(...)``, or ``plan.shared`` of
  ``plan = launch_shape(...)``).
- ``SHM002`` *an unchecked byte count*: a ``launch_shape``/
  ``launch_plan`` returns a byte count on a path where no earlier ``if``
  compares it with ``MAX_SHARED_BYTES`` and raises past it (or the return
  is not inside such a comparison).

These take the place of ``repro``'s ``ENV001``-``ENV004``, which check
the TPU's VMEM envelopes; the card has no such envelope.  ``repro``'s
``DMA001``-``DMA004`` (async-copy discipline of the streamed Pallas tier)
and ``TRC001``-``TRC002`` (Python control flow on traced values) have no
counterpart: the kernels are CUDA C++, not traced Python, and the card has
no streamed tier.
"""

from __future__ import annotations

import ast

from repro_torch.analysis.astutil import (SourceFile, call_callee,
                                          dotted_name, iter_functions,
                                          local_assigns)
from repro_torch.analysis.findings import Finding

_PLANS = ("launch_shape", "launch_plan")
_LIMIT = "MAX_SHARED_BYTES"


def _is_bytes_name(name: str | None) -> bool:
    if name is None:
        return False
    tail = name.rsplit(".", 1)[-1].lower()
    return "shared" in tail or "smem" in tail


def _is_plan_call(expr: ast.expr) -> bool:
    return isinstance(expr, ast.Call) and \
        (call_callee(expr) or "").rsplit(".", 1)[-1] in _PLANS


def _kernel_files(files: list[SourceFile]) -> list[SourceFile]:
    """``kernels/`` when present, else the whole tree (fixture corpora
    are flat)."""
    scoped = [sf for sf in files if sf.rel.startswith("kernels/")]
    return scoped or files


def _from_plan(arg: ast.expr, assigns: dict[str, list[ast.expr]]) -> bool:
    """True when ``arg`` is bound from a plan call in the function."""
    if isinstance(arg, ast.Name):
        values = assigns.get(arg.id, [])
    elif isinstance(arg, ast.Attribute) and isinstance(arg.value, ast.Name):
        values = assigns.get(arg.value.id, [])
    else:
        return False
    return bool(values) and all(_is_plan_call(v) for v in values)


def _launch_findings(sf: SourceFile) -> list[Finding]:
    out = []
    for _, fn in iter_functions(sf.tree):
        if fn.name in _PLANS:
            continue
        assigns = local_assigns(fn)
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call) or _is_plan_call(node):
                continue
            args = list(node.args) + [kw.value for kw in node.keywords]
            for arg in args:
                if isinstance(arg, (ast.Name, ast.Attribute)) \
                        and _is_bytes_name(dotted_name(arg)) \
                        and not _from_plan(arg, assigns):
                    out.append(Finding(
                        "SHM001", sf.rel, arg.lineno,
                        f"launch passes the shared-memory byte count "
                        f"{dotted_name(arg)!r}, which does not come from "
                        "the kernel's launch_shape/launch_plan"))
    return out


def _compares_limit(test: ast.expr) -> bool:
    return any(isinstance(n, ast.Compare) and any(
        (dotted_name(x) or "").endswith(_LIMIT)
        for x in [n.left, *n.comparators]) for n in ast.walk(test))


def _guard(stmt: ast.stmt) -> bool:
    """An ``if`` comparing with the limit whose body raises."""
    return isinstance(stmt, ast.If) and _compares_limit(stmt.test) \
        and any(isinstance(n, ast.Raise) for b in stmt.body
                for n in ast.walk(b))


def _guarded_returns(body: list[ast.stmt], guarded: bool, out: list):
    """(return, guarded) of every return in ``body``: guarded when an
    earlier guard in an enclosing statement list, or an enclosing ``if``
    on the limit, precedes it."""
    for stmt in body:
        if isinstance(stmt, ast.Return):
            out.append((stmt, guarded))
        elif isinstance(stmt, ast.If):
            inner = guarded or _compares_limit(stmt.test)
            _guarded_returns(stmt.body, inner, out)
            _guarded_returns(stmt.orelse, inner, out)
        elif isinstance(stmt, (ast.For, ast.While, ast.With, ast.Try)):
            for block in ("body", "orelse", "finalbody"):
                _guarded_returns(getattr(stmt, block, []), guarded, out)
            for h in getattr(stmt, "handlers", []):
                _guarded_returns(h.body, guarded, out)
        guarded = guarded or _guard(stmt)


def _returns_bytes(ret: ast.Return) -> bool:
    return ret.value is not None and any(
        isinstance(n, (ast.Name, ast.Attribute))
        and _is_bytes_name(dotted_name(n)) for n in ast.walk(ret.value))


def _plan_findings(sf: SourceFile) -> list[Finding]:
    out = []
    for node in sf.tree.body:
        if not (isinstance(node, ast.FunctionDef) and node.name in _PLANS):
            continue
        returns: list = []
        _guarded_returns(node.body, False, returns)
        for ret, guarded in returns:
            if _returns_bytes(ret) and not guarded:
                out.append(Finding(
                    "SHM002", sf.rel, ret.lineno,
                    f"{node.name} returns a shared-memory byte count on a "
                    f"path that does not compare it with {_LIMIT} and "
                    "raise past it"))
    return out


def check(files: list[SourceFile]) -> list[Finding]:
    out: list[Finding] = []
    for sf in _kernel_files(files):
        out += _launch_findings(sf)
        out += _plan_findings(sf)
    return out
