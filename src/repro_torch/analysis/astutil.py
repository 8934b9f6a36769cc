"""Shared AST machinery for the sanitizer rules.

Every rule works on parsed source (``ast``): the checked modules are never
imported, so the sanitizer runs the same with or without torch or a card,
and cannot be fooled by import-time behaviour.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator


@dataclass
class SourceFile:
    """One parsed source file (path relative to the scan root)."""

    path: Path
    rel: str
    source: str
    tree: ast.Module


def load_tree(root: Path) -> list[SourceFile]:
    """Parse every ``.py`` file under ``root`` (or the file itself)."""
    paths = [root] if root.is_file() else sorted(root.rglob("*.py"))
    base = root.parent if root.is_file() else root
    out: list[SourceFile] = []
    for p in paths:
        src = p.read_text()
        out.append(SourceFile(path=p, rel=p.relative_to(base).as_posix(),
                              source=src, tree=ast.parse(src)))
    return out


def dotted_name(node: ast.expr) -> str | None:
    """``a.b.c`` -> "a.b.c"; None for anything not a pure name chain."""
    parts: list[str] = []
    cur: ast.expr = node
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if isinstance(cur, ast.Name):
        parts.append(cur.id)
        return ".".join(reversed(parts))
    return None


def call_callee(node: ast.Call) -> str | None:
    """The dotted callee name of a call, if it is a plain name chain."""
    return dotted_name(node.func)


def iter_functions(tree: ast.Module) -> Iterator[
        tuple[str, ast.FunctionDef | ast.AsyncFunctionDef]]:
    """Yield (qualname, node) for every function and method, nested ones
    included (qualnames are dotted: ``Class.method``,
    ``outer.<locals>.inner``)."""

    def walk(node: ast.AST, prefix: str) -> Iterator[
            tuple[str, ast.FunctionDef | ast.AsyncFunctionDef]]:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                q = f"{prefix}{child.name}"
                yield q, child
                yield from walk(child, f"{q}.<locals>.")
            elif isinstance(child, ast.ClassDef):
                yield from walk(child, f"{prefix}{child.name}.")
            else:
                yield from walk(child, prefix)

    yield from walk(tree, "")


def top_level_functions(tree: ast.Module) -> dict[str, ast.FunctionDef]:
    """Module-level ``def``s by name (no methods, no nested defs)."""
    return {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}


def class_defs(tree: ast.Module) -> dict[str, ast.ClassDef]:
    return {n.name: n for n in tree.body if isinstance(n, ast.ClassDef)}


def local_assigns(fn: ast.AST) -> dict[str, list[ast.expr]]:
    """Every value bound to a plain name in ``fn`` (``x = ...``, and each
    name of a tuple target ``a, x = ...``, bound to the whole value)."""
    out: dict[str, list[ast.expr]] = {}
    for node in ast.walk(fn):
        if not isinstance(node, ast.Assign):
            continue
        for target in node.targets:
            names = ([target] if isinstance(target, ast.Name) else
                     [e for e in target.elts if isinstance(e, ast.Name)]
                     if isinstance(target, ast.Tuple) else [])
            for name in names:
                out.setdefault(name.id, []).append(node.value)
    return out
