"""The port's two examples on the CPU (``--device cpu``):
``examples/torch_quickstart.py`` prints what ``examples/quickstart.py``
prints, line for line (the saved container's path and size aside), and
``examples/torch_serve_autocomplete.py`` at a small ``--n`` prints the
lines of ``examples/serve_autocomplete.py``'s format: a line a structure
(tt, et, ht, et+cache) with its bytes a string, the keystroke line with
its count, and five queries with the port index's own suggestions;
``examples/torch_autocomplete_rerank.py`` prints the popularity lines of
``examples/autocomplete_rerank.py`` (its user-aware lines rank by a
SASRec model of other random weights)."""

import ast
import re
import runpy
import sys
from pathlib import Path

import pytest
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
SERVE_ARGS = ["--n", "400", "--queries", "16", "--batch", "8", "--k", "5"]


def _run(path, argv, capsys, monkeypatch):
    """Run an example as ``__main__`` with ``argv``; its printed lines."""
    monkeypatch.setattr(sys, "argv", [str(path)] + argv)
    capsys.readouterr()
    runpy.run_path(str(path), run_name="__main__")
    return capsys.readouterr().out.splitlines()


def _stable(line: str) -> str:
    """A line with the saved container's path and size taken out."""
    return re.sub(r"/\S+/fig1\.npz \(\d+", "<path> (<n>", line)


def test_quickstart_prints_what_repro_prints(capsys, monkeypatch):
    ours = _run(EXAMPLES / "torch_quickstart.py", ["--device", "cpu"],
                capsys, monkeypatch)
    theirs = _run(EXAMPLES / "quickstart.py", [], capsys, monkeypatch)
    assert [_stable(x) for x in ours] == [_stable(x) for x in theirs]
    assert len(ours) > 20


def test_serve_autocomplete_prints_repros_lines(capsys, monkeypatch):
    import repro_torch as rt
    from repro_torch.core import make_rules
    from repro_torch.data.strings import make_usps, make_workload

    out = _run(EXAMPLES / "torch_serve_autocomplete.py",
               SERVE_ARGS + ["--device", "cpu"], capsys, monkeypatch)
    assert out[0] == "building USPS-like dataset: 400 strings ..."
    for line, kind in zip(out[1:5], ("tt", "et", "ht", "et+cache")):
        assert re.fullmatch(
            rf"{re.escape(kind)}\s+build\s+[\d.]+s\s+[\d.]+ B/string\s+"
            r"[\d.]+ us/completion\s+\d+ q/s", line), line
    assert re.fullmatch(r"keystroke sessions: \d+ keystrokes\s+[\d.]+ "
                        r"us/keystroke\s+p99\s+[\d.]+ ms", out[5]), out[5]
    ds = make_usps(n=400, seed=0)
    idx = rt.build_index(ds.strings, ds.scores, make_rules(ds.rules),
                         rt.IndexSpec(kind="et", cache_k=16), device="cpu")
    queries = make_workload(ds, 16, seed=1, max_len=16)
    assert out[6:] == [f"  {q!r} -> {[s for _, s in idx.complete([q], 3)[0]]}"
                       for q in queries[:5]]


def test_rerank_prints_repros_popularity_lines(capsys, monkeypatch):
    ours = _run(EXAMPLES / "torch_autocomplete_rerank.py",
                ["--device", "cpu"], capsys, monkeypatch)
    theirs = _run(EXAMPLES / "autocomplete_rerank.py", [], capsys,
                  monkeypatch)
    assert len(ours) == len(theirs) == 12
    for a, b in zip(ours, theirs):
        if "popularity:" in b:
            assert a == b
        else:
            assert a.split(":")[0] == b.split(":")[0]
    # the user-aware lines rerank the same candidates
    for a, b in zip(ours[1::3], theirs[1::3]):
        assert sorted(ast.literal_eval(a.split(": ", 1)[1])) == \
            sorted(ast.literal_eval(b.split(": ", 1)[1]))


def test_examples_default_to_the_card():
    for name in ("torch_quickstart", "torch_serve_autocomplete",
                 "torch_autocomplete_rerank"):
        text = (EXAMPLES / f"{name}.py").read_text()
        assert 'ap.add_argument("--device", default="cuda"' in text, name
