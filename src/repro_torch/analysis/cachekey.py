"""Rule family KEY: compile-cache key completeness.

The index's compile cache (``api/compile_cache.py``) holds prepared entry
points under key tuples the call sites assemble by hand; an entry closes
over the ``EngineConfig`` it was made with.  A config field that changes
what a cached path does but not its key silently serves a stale entry.

- ``KEY001`` *field missing from a cache key*: an ``EngineConfig`` field
  is read on a cached path (``core/engine/``, ``kernels/``, or the factory
  given to a ``*_cache.get``) but the key tuple passed to that ``get``
  holds neither the whole config object nor that field.
- ``KEY002`` *config not hashable by value*: ``EngineConfig`` is not a
  ``@dataclass(frozen=True)``; an unfrozen config hashes by identity (or
  not at all), so equal configs stop sharing cache entries.

``repro``'s ``KEY003`` (a config field passed to a jitted function
outside its ``static_argnames``) has no counterpart: the port traces
nothing, so it has no ``static_argnames``.
"""

from __future__ import annotations

import ast

from repro_torch.analysis.astutil import (SourceFile, call_callee,
                                          class_defs, dotted_name,
                                          iter_functions)
from repro_torch.analysis.findings import Finding

_CONFIG_CLASS = "EngineConfig"


def config_fields(files: list[SourceFile]) -> tuple[SourceFile | None,
                                                    ast.ClassDef | None,
                                                    set[str]]:
    """Locate the ``EngineConfig`` dataclass and its field names."""
    for sf in files:
        cls = class_defs(sf.tree).get(_CONFIG_CLASS)
        if cls is not None:
            fields = {n.target.id for n in cls.body
                      if isinstance(n, ast.AnnAssign)
                      and isinstance(n.target, ast.Name)}
            return sf, cls, fields
    return None, None, set()


def _is_frozen_dataclass(cls: ast.ClassDef) -> bool:
    for dec in cls.decorator_list:
        if isinstance(dec, ast.Call) and (call_callee(dec) or "") \
                .split(".")[-1] == "dataclass":
            for kw in dec.keywords:
                if kw.arg == "frozen" \
                        and isinstance(kw.value, ast.Constant) \
                        and kw.value.value is True:
                    return True
    return False


def _cfg_field_reads(tree: ast.AST, fields: set[str]) -> dict[str, int]:
    """``cfg.<field>`` reads (base named ``cfg`` or ``*.cfg``) -> first
    line."""
    out: dict[str, int] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute) and node.attr in fields:
            base = dotted_name(node.value)
            if base is not None and (base == "cfg"
                                     or base.endswith(".cfg")):
                out.setdefault(node.attr, node.lineno)
    return out


def _cached_scope_files(files: list[SourceFile]) -> list[SourceFile]:
    """The cached paths' modules: ``core/engine/`` and ``kernels/`` when
    present, else the whole tree (fixture corpora are flat)."""
    scoped = [sf for sf in files
              if sf.rel.startswith(("core/engine/", "kernels/"))]
    return scoped or files


def _key_sites(sf: SourceFile) -> list[tuple[ast.expr, int, ast.AST | None]]:
    """(key expression, line, factory definition or None) of every
    ``*_cache.get(key, factory)`` call, with ``key`` and ``factory``
    resolved through the enclosing function's assignments and ``def``s."""
    out = []
    for _, fn in iter_functions(sf.tree):
        assigns: dict[str, ast.expr] = {}
        defs: dict[str, ast.AST] = {}
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                assigns[node.targets[0].id] = node.value
            elif isinstance(node, ast.FunctionDef) and node is not fn:
                defs[node.name] = node
        for node in ast.walk(fn):
            if not (isinstance(node, ast.Call) and len(node.args) >= 2):
                continue
            callee = call_callee(node)
            if callee is None or not callee.endswith("_cache.get"):
                continue
            key = node.args[0]
            if isinstance(key, ast.Name):
                key = assigns.get(key.id, key)
            factory = node.args[1]
            if isinstance(factory, ast.Name):
                factory = defs.get(factory.id, assigns.get(factory.id))
            out.append((key, getattr(key, "lineno", node.lineno), factory))
    return out


def _key_coverage(key: ast.expr, fields: set[str]) -> tuple[bool, set[str]]:
    """(covers the whole config, the fields named explicitly)."""
    covers_all = False
    covered: set[str] = set()
    # a "cfg" that is only the base of a field access (cfg.frontier) puts
    # that field in the key, not the whole object
    bases = {id(node.value) for node in ast.walk(key)
             if isinstance(node, ast.Attribute)}
    for node in ast.walk(key):
        if isinstance(node, ast.Attribute) and node.attr in fields:
            covered.add(node.attr)
        if id(node) in bases:
            continue
        name = dotted_name(node) if isinstance(
            node, (ast.Name, ast.Attribute)) else None
        if name is not None and (name == "cfg" or name.endswith(".cfg")):
            covers_all = True
    return covers_all, covered


def check(files: list[SourceFile]) -> list[Finding]:
    cfg_sf, cfg_cls, fields = config_fields(files)
    if cfg_cls is None or cfg_sf is None:
        return []
    out: list[Finding] = []

    if not _is_frozen_dataclass(cfg_cls):
        out.append(Finding(
            "KEY002", cfg_sf.rel, cfg_cls.lineno,
            f"{_CONFIG_CLASS} is not a frozen dataclass — it must hash "
            "by value to serve as a compile-cache key component"))

    # KEY001: the fields read on the cached scope (and in the factory)
    # against every key site
    reads: dict[str, tuple[str, int]] = {}
    for sf in _cached_scope_files(files):
        for field, line in _cfg_field_reads(sf.tree, fields).items():
            reads.setdefault(field, (sf.rel, line))
    for sf in files:
        for key, line, factory in _key_sites(sf):
            covers_all, covered = _key_coverage(key, fields)
            if covers_all:
                continue
            site_reads = dict(reads)
            if factory is not None:
                for field, fl in _cfg_field_reads(factory, fields).items():
                    site_reads.setdefault(field, (sf.rel, fl))
            for field in sorted(set(site_reads) - covered):
                rf, rl = site_reads[field]
                out.append(Finding(
                    "KEY001", sf.rel, line,
                    f"compile-cache key omits EngineConfig.{field}, "
                    f"which is read on a cached path ({rf}:{rl}) — "
                    "changing it would reuse a stale entry"))
    return out
