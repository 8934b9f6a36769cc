"""CLI: ``python -m repro_torch.analysis [paths...] [--fail-on-findings]
[--show-waived]``.

Prints one ``RULE-ID file:line message`` per finding and a summary.
Without ``--fail-on-findings`` the run is informational (exit 0 either
way); with it, the gate, any unwaived finding exits 1.
"""

from __future__ import annotations

import argparse
import sys

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.runner import default_root, run_all


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Kernel sanitizer: static compile-cache-key and "
                    "shared-memory checks.")
    p.add_argument("paths", nargs="*",
                   help="source trees to scan (default: the installed "
                        "repro_torch package)")
    p.add_argument("--fail-on-findings", action="store_true",
                   help="exit 1 when any unwaived finding remains")
    p.add_argument("--show-waived", action="store_true",
                   help="also print findings suppressed by waivers")
    args = p.parse_args(argv)

    roots = args.paths or [default_root()]
    findings: list[Finding] = []
    for root in roots:
        findings += run_all(root)
    active = [f for f in findings if not f.waived]
    waived = [f for f in findings if f.waived]
    shown = findings if args.show_waived else active
    for f in shown:
        print(f.format())
    print(f"{len(active)} finding(s), {len(waived)} waived "
          f"({len(roots)} tree(s) scanned)")
    if active and args.fail_on_findings:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
