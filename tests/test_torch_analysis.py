"""The port's static checks (``python -m repro_torch.analysis``): the
planted fixture corpus (``tests/fixtures/torch_sanitizer/``, each
violation marked ``# PLANT: RULE``) reported rule for rule at its line
and nothing else, the port's own tree clean, waiver semantics, and the
CLI's exit codes.  The same contract as ``repro.analysis``'s tests, over
the port's two rule families (KEY, SHM)."""

import re
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.analysis.__main__ import main as analysis_main
from repro_torch.analysis.astutil import load_tree
from repro_torch.analysis.runner import default_root, run_all
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = Path(__file__).parent / "fixtures" / "torch_sanitizer"
RULES = ("KEY001", "KEY002", "SHM001", "SHM002")

_PLANT_RE = re.compile(r"#\s*PLANT:\s*([A-Z0-9 ]+?)\s*$")


def _planted() -> set[tuple[str, str, int]]:
    out = set()
    for path in sorted(FIXTURES.glob("*.py")):
        for i, line in enumerate(path.read_text().splitlines(), start=1):
            m = _PLANT_RE.search(line)
            if m:
                for rule in m.group(1).split():
                    out.add((rule, path.name, i))
    return out


def _reported(root) -> set[tuple[str, str, int]]:
    return {(f.rule, f.file, f.line) for f in run_all(root) if not f.waived}


@pytest.mark.parametrize("rule", RULES)
def test_each_planted_rule_reported_at_its_line(rule):
    planted = {p for p in _planted() if p[0] == rule}
    assert planted, f"the fixture corpus plants no {rule}"
    assert planted <= _reported(FIXTURES)


def test_fixture_corpus_reports_nothing_unplanted():
    extra = _reported(FIXTURES) - _planted()
    assert not extra, f"unplanted findings: {sorted(extra)}"


def test_port_tree_is_clean_and_scanned():
    findings = [f for f in run_all(default_root()) if not f.waived]
    assert not findings, "\n".join(f.format() for f in findings)
    scanned = {sf.rel for sf in load_tree(default_root())}
    for mod in ("api/index.py", "core/distributed.py", "kernels/locus_dp.py",
                "kernels/beam_topk.py", "kernels/locus_merge.py",
                "kernels/topk_select.py", "kernels/trie_walk.py",
                "kernels/candidate_topk.py", "core/engine/structs.py"):
        assert mod in scanned, mod


def _write(tmp_path, source: str) -> Path:
    (tmp_path / "mod.py").write_text(source)
    return tmp_path


LAUNCH = ("def launch(loci):\n"
          "    shared = 4 * loci.shape[1]\n"
          "{waiver}"
          "    return _lib()(loci, shared)\n")


def test_waiver_with_reason_suppresses(tmp_path):
    root = _write(tmp_path, LAUNCH.format(
        waiver="    # sanitizer: waive[SHM001] a fixed scratch, far under "
               "the limit\n"))
    findings = run_all(root)
    assert [(f.rule, f.waived) for f in findings] == [("SHM001", True)]


def test_waiver_only_covers_its_rule(tmp_path):
    root = _write(tmp_path, LAUNCH.format(
        waiver="    # sanitizer: waive[SHM002] the wrong rule\n"))
    assert [f.rule for f in run_all(root) if not f.waived] == ["SHM001"]


def test_waiver_without_reason_is_itself_reported(tmp_path):
    root = _write(tmp_path, LAUNCH.format(
        waiver="    # sanitizer: waive[SHM001]\n"))
    rules = {(f.rule, f.line): f.waived for f in run_all(root)}
    assert rules == {("SHM001", 4): True, ("WAIV01", 3): False}


def test_cli_exits_1_on_fixtures_and_0_on_the_port(capsys):
    assert analysis_main([str(FIXTURES), "--fail-on-findings"]) == 1
    assert analysis_main([str(FIXTURES)]) == 0      # informational
    out = capsys.readouterr().out
    n = len([f for f in run_all(FIXTURES) if not f.waived])
    assert out.count(f"{n} finding(s), 0 waived") == 2
    assert analysis_main(["--fail-on-findings"]) == 0
    assert "0 finding(s)" in capsys.readouterr().out


def test_cli_as_a_module_shows_waived(tmp_path):
    root = _write(tmp_path, LAUNCH.format(
        waiver="    # sanitizer: waive[SHM001] a fixed scratch\n"))
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", str(root),
         "--fail-on-findings", "--show-waived"], capture_output=True,
        text=True, timeout=60, env={"PYTHONPATH": str(ROOT / "src")})
    assert run.returncode == 0, run.stderr
    assert "SHM001 mod.py:4" in run.stdout and "(waived)" in run.stdout
    assert "0 finding(s), 1 waived" in run.stdout
