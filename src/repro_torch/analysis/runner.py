"""Runs the rule families over a source tree and applies the waivers.

``run_all(root)`` parses every ``.py`` under ``root`` (default: the
``repro_torch`` package source), runs the two rule families and applies
the inline waiver comments.  The analyzer never imports the checked code:
a tree that fails to *parse* raises, one that fails to import analyzes
fine.
"""

from __future__ import annotations

from pathlib import Path

from repro_torch.analysis import cachekey, shm
from repro_torch.analysis.astutil import load_tree
from repro_torch.analysis.findings import (Finding, FileWaivers,
                                           apply_waivers, scan_waivers)

#: relative path prefixes left out of the scan: the analyzer does not
#: police itself (its sources quote the patterns it matches)
_EXCLUDE_PREFIXES = ("analysis",)


def default_root() -> Path:
    """The ``repro_torch`` package source directory this module ships in."""
    return Path(__file__).resolve().parents[1]


def run_all(root: Path | str | None = None) -> list[Finding]:
    """Run every rule family over ``root``; returns the findings sorted by
    location, waived entries flagged (not dropped: the CLI decides what
    to show and what to fail on)."""
    root = Path(root) if root is not None else default_root()
    files = [sf for sf in load_tree(root)
             if not sf.rel.startswith(_EXCLUDE_PREFIXES)]
    findings: list[Finding] = []
    findings += cachekey.check(files)
    findings += shm.check(files)
    waivers: dict[str, FileWaivers] = {}
    for sf in files:
        fw = scan_waivers(sf.path, sf.source)
        fw.path = sf.rel
        if fw.waivers:
            waivers[sf.rel] = fw
    findings = apply_waivers(findings, waivers)
    return sorted(findings, key=lambda f: (f.file, f.line, f.rule))
