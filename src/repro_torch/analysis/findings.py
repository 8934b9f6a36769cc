"""Findings and inline waivers.

A :class:`Finding` is one rule violation anchored to ``file:line``.  The
waiver syntax is deliberately narrow: ``# sanitizer: waive[RULE-ID]
<reason>`` on the flagged line or the line directly above it, one rule id
per waiver (``*`` waives every rule on that line), reason mandatory.
Waivers without a reason are themselves reported (``WAIV01``), so a
waiver is always a reviewed, justified artifact rather than a mute
button.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from pathlib import Path

_WAIVER_RE = re.compile(
    r"#\s*sanitizer:\s*waive\[(?P<rule>[A-Z]+[0-9]*|\*)\]\s*(?P<reason>.*)$")


@dataclass(frozen=True)
class Finding:
    """One rule violation at ``file:line``."""

    rule: str
    file: str
    line: int
    message: str
    waived: bool = False

    def format(self) -> str:
        tag = " (waived)" if self.waived else ""
        return f"{self.rule} {self.file}:{self.line} {self.message}{tag}"


@dataclass(frozen=True)
class Waiver:
    """An inline ``# sanitizer: waive[RULE]`` comment."""

    rule: str
    line: int
    reason: str


@dataclass
class FileWaivers:
    """All waivers of one file, indexed by the lines they cover."""

    path: str
    waivers: list[Waiver] = field(default_factory=list)

    def covers(self, rule: str, line: int) -> Waiver | None:
        """The waiver covering ``rule`` at ``line``, if any.  A waiver
        covers its own line and the line directly below it (the
        waiver-above-the-statement form)."""
        for w in self.waivers:
            if w.line in (line, line - 1) and w.rule in (rule, "*"):
                return w
        return None


def scan_waivers(path: Path, source: str | None = None) -> FileWaivers:
    """Parse every waiver comment of one file."""
    if source is None:
        source = path.read_text()
    out = FileWaivers(path=str(path))
    for i, text in enumerate(source.splitlines(), start=1):
        m = _WAIVER_RE.search(text)
        if m is not None:
            out.waivers.append(Waiver(rule=m.group("rule"), line=i,
                                      reason=m.group("reason").strip()))
    return out


def apply_waivers(findings: list[Finding],
                  waivers: dict[str, FileWaivers]) -> list[Finding]:
    """Mark findings covered by a waiver; report reason-less waivers.

    Returns the finding list with covered entries flagged ``waived=True``
    plus one ``WAIV01`` finding per waiver missing its justification.
    """
    out: list[Finding] = []
    for f in findings:
        fw = waivers.get(f.file)
        w = fw.covers(f.rule, f.line) if fw is not None else None
        if w is not None:
            out.append(Finding(f.rule, f.file, f.line, f.message,
                               waived=True))
        else:
            out.append(f)
    for fw in waivers.values():
        for w in fw.waivers:
            if not w.reason:
                out.append(Finding(
                    "WAIV01", fw.path, w.line,
                    f"waiver for {w.rule} has no justification — "
                    "a waiver must say why the invariant holds anyway"))
    return out
