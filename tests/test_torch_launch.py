"""The serving launcher: ``repro_torch.launch.serve`` against
``repro.launch.serve`` (``substrate="jnp"``) on the CPU.

Each workload runs through the port's ``main(argv)`` and through
``repro``'s workload function on the same arguments; the JSON lines must
have the same keys and the same deterministic numbers (kind, strings,
queries, keystrokes, hit rate, bit-identity, lost keystrokes, ...), and
the launcher's own checks must hold.  The churn workload and the
launcher's check up to ties are in ``tests/test_torch_launch_churn.py``.
"""

import argparse
import json

import pytest
import torch

import repro_torch as rt
from repro.configs import get_arch as jax_arch
from repro import serving as jax_serving
from repro.api import IndexSpec as JaxSpec
from repro.api import build_index as jax_build
from repro.launch import serve as jax_serve
from repro_torch.launch import serve
from torch_fast_jit import fast_jax_jit  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

ARGS = ["--arch", "autocomplete-usps", "--n-strings", "1000",
        "--device", "cpu"]
#: per workload, the launcher's extra flags and the keys that must equal
#: repro's (timings excepted)
WORKLOADS = {
    "batch": (["--queries", "12"],
              ("kind", "compression", "memory_budget", "workload",
               "n_strings", "bytes_per_string", "queries", "hit_rate")),
    "keystroke": (["--queries", "12"],
                  ("kind", "workload", "n_strings", "queries", "keystrokes",
                   "hit_rate")),
    "zipf": (["--queries", "4", "--sessions", "4", "--repeats", "1"],
             ("kind", "workload", "n_strings", "sessions", "block",
              "queries", "keystrokes", "bit_identical", "fallbacks")),
    # one mutation batch and one compaction, after the stream: keystrokes
    # under pending mutations take the merged lookup, and each of repro's
    # compactions re-jits its shapes (the smoke's phase 4b compacts
    # mid-stream on the card)
    "churn": (["--queries", "4", "--churn-every", "60", "--compact-at",
               "1000"],
              ("kind", "workload", "n_strings", "sessions", "block",
               "keystrokes", "mutations", "compactions", "final_epoch",
               "lost_keystrokes", "verified")),
}


def _jax(argv):
    """repro's workload function on the same arguments (jnp substrate)."""
    args = serve.parser().parse_args(argv)
    ns = argparse.Namespace(**{**vars(args), "substrate": "jnp"})
    fn = {"batch": jax_serve.serve_autocomplete,
          "keystroke": jax_serve.serve_keystroke,
          "zipf": jax_serve.serve_zipf,
          "churn": jax_serve.serve_churn}[args.workload]
    return fn(jax_arch(args.arch), ns)


# (the churn workload is the same test's case in
# tests/test_torch_launch_churn.py: one file would take longer than a
# minute, repro re-jitting every shape after its compaction)
@pytest.mark.parametrize("workload", ["batch", "keystroke", "zipf"])
def test_workload_equals_repro(workload, capsys):
    check_workload(workload, capsys)


def check_workload(workload, capsys):
    """The port's JSON line for ``workload`` against repro's: the same
    keys, the deterministic numbers equal, the launcher's checks held."""
    extra, same = WORKLOADS[workload]
    argv = ARGS + ["--workload", workload] + extra
    out = serve.main(argv)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == out and out["substrate"] == "torch"
    want = _jax(argv)
    assert set(out) == set(want)
    assert {k: out[k] for k in same} == {k: want[k] for k in same}
    if workload in ("zipf", "churn"):
        assert out.get("bit_identical", True) and out.get("verified", True)
        assert out.get("lost_keystrokes", 0) == 0
        assert out.get("fallbacks", 0) == 0
    if workload == "churn":
        assert out["compactions"] == 1 and sum(out["mutations"].values())


def test_sessions_without_events_release_their_lanes():
    """Events for two of three sessions, replayed twice through one
    batching service: repro's replay leaves the idle session open, so its
    second replay finds no free lane; the port's closes it and answers as
    its sequential replay."""
    events = [(0, -1), (0, ord("a")), (1, -1), (1, ord("w")),
              (0, ord("n")), (1, ord("i"))]
    paper = (["andrew pavlo", "william smith", "andy x"], [5, 4, 3])
    idx = rt.build_index(*paper, [], kind="et", device="cpu")
    bat = rt.CompletionService(idx, batching=True, block=3)
    want = serve._replay_sequential(rt.CompletionService(idx), events, 3)
    for _ in range(2):
        assert serve._replay_batched(bat, events, 3) == want
    jx = jax_serving.CompletionService(
        jax_build(*paper, [], JaxSpec(kind="et", substrate="jnp")),
        batching=True, block=3)
    jax_serve._replay_batched(jx, events, 3)
    with pytest.raises(jax_serving.SchedulerOverloaded, match="lanes"):
        jax_serve._replay_batched(jx, events, 3)


def test_save_load_and_substrates(tmp_path, capsys):
    """A batch run saves its container; batch and keystroke runs load it
    (the kernel routing, whose wrappers answer CPU tensors with their
    plain versions, and the torch substrate) with the built index's hit
    rate; the memory budget is carried."""
    path = str(tmp_path / "usps.npz")
    built = serve.main(ARGS + ["--queries", "12", "--save-index", path,
                               "--cache-k", "16", "--memory-budget", "4096"])
    assert built["memory_budget"] == 4096
    for sub in ("cuda", "torch"):
        loaded = serve.main(ARGS + ["--queries", "12", "--load-index", path,
                                    "--substrate", sub])
        assert loaded["substrate"] == sub
        assert loaded["hit_rate"] == built["hit_rate"]
        assert loaded["bytes_per_string"] == built["bytes_per_string"]
    typed = serve.main(ARGS + ["--queries", "4", "--load-index", path,
                               "--workload", "keystroke"])
    assert typed["keystrokes"] > 0 and typed["hit_rate"] > 0
    capsys.readouterr()


def test_other_archs_are_not_ported(monkeypatch):
    """The recsys and GNN archs have no serve mode: the launcher exits with
    ``repro``'s message."""
    for arch, family in (("sasrec", "recsys"), ("gin-tu", "gnn")):
        with pytest.raises(SystemExit) as ours:
            serve.main(["--arch", arch, "--device", "cpu"])
        monkeypatch.setattr("sys.argv", ["serve", "--arch", arch])
        with pytest.raises(SystemExit) as theirs:
            jax_serve.main()
        assert str(ours.value) == str(theirs.value) == \
            f"no serve mode for family {family}"
    with pytest.raises(KeyError, match="unknown arch"):
        serve.main(["--arch", "no-such-arch", "--device", "cpu"])
