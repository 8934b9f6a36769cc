"""Quickstart on the PyTorch/CUDA port: the paper's Fig. 1 example.

The counterpart of ``quickstart.py`` (the same output lines), through
``repro_torch``'s API.  Runs on the card; pass ``--device cpu`` to run
the kernels' plain versions on the CPU.

  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""

import argparse
import os
import tempfile

from repro_torch.api import CompletionIndex, IndexSpec, build_index
from repro_torch.core import make_rules


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="the index's device (default: cuda)")
    args = ap.parse_args(argv)

    strings = ["Andrew Pavlo", "Andrew Parker", "Andrew Packard",
               "Andy Warhol Museum", "William Smith"]
    scores = [50, 40, 30, 25, 20]
    rules = make_rules([("Andy", "Andrew"), ("Bill", "William")])

    # -- declarative builds: one IndexSpec per structure ----------------------
    for kind in ("tt", "et", "ht"):
        index = build_index(strings, scores, rules, IndexSpec(kind=kind),
                            device=args.device)
        print(f"\n== {kind.upper()} "
              f"({index.stats.bytes_per_string:.0f} bytes/string) ==")
        for query in ("Andy Pa", "Bill", "Andrew P"):
            suggestions = index.complete([query], k=3)[0]
            print(f"  {query!r:12} -> "
                  + (", ".join(f"{s}:{score}" for score, s in suggestions)
                     or "(no match)"))

    # -- persistence: build once, restore without reconstruction --------------
    index = build_index(strings, scores, rules,
                        IndexSpec(kind="ht", alpha=0.5), device=args.device)
    path = os.path.join(tempfile.mkdtemp(), "fig1.npz")
    index.save(path)
    restored = CompletionIndex.load(path, device=args.device)
    assert restored.complete(["Andy Pa"], k=3) == \
        index.complete(["Andy Pa"], k=3)
    print(f"\nsaved + restored from {path} "
          f"({os.path.getsize(path)} bytes on disk)")

    # -- incremental typing: a session advances the frontier per keystroke ----
    session = restored.session(k=3)
    print("\ntyping 'Andy Pa' one keystroke at a time:")
    for ch in "Andy Pa":
        suggestions = session.type(ch)
        print(f"  {session.prefix!r:12} -> "
              + (", ".join(s for _, s in suggestions) or "(no match)"))
    session.backspace(2)
    print(f"  after 2x backspace {session.prefix!r}: "
          + ", ".join(s for _, s in session.topk()))


if __name__ == "__main__":
    main()
