"""The serving launcher's churn workload, continued from
``tests/test_torch_launch.py`` (whose helpers it uses): the port's
``main(argv)`` against ``repro.launch.serve.serve_churn`` on the CPU, and
the launcher's check up to ties.  One file would take longer than a
minute on one worker: ``repro`` re-jits every shape after the
compaction."""

import numpy as np
import pytest

import repro_torch as rt
from repro_torch.core.trie_build import make_rules
from repro_torch.data import strings as port_strings
from repro_torch.launch import serve
from test_torch_launch import check_workload
from torch_fast_jit import fast_jax_jit  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("workload", ["churn"])
def test_workload_equals_repro(workload, capsys):
    check_workload(workload, capsys)


def test_churn_verifies_up_to_ties():
    """On tie-heavy scores the overlay-merged answer orders a tie by
    string, the rebuilt index's beam by its search order (as in repro,
    whose churn check then fails): the launcher's check holds the two
    equal up to that order (k = 40 keeps every match, k = 4 cuts the
    ties), and still fails a changed score or string."""
    ds = port_strings.make_usps(200, seed=1)
    scores = np.random.default_rng(1).choice([5, 9], 200)
    idx = rt.build_index(ds.strings, scores, make_rules(ds.rules),
                         kind="et", device="cpu")
    idx.insert(b"zz~trending-0", 5)
    idx.delete(idx.strings[3])
    probes = [b"a", b"b", b"d", b"j"]
    pre = {k: idx.complete(probes, k=k) for k in (4, 40)}
    idx.compact()
    for k in (4, 40):
        post = idx.complete(probes, k=k)
        assert pre[k] != post and serve._same_up_to_ties(pre[k], post, k)
    rescored = [list(r) for r in post]
    rescored[0][0] = (rescored[0][0][0] - 1, rescored[0][0][1])
    renamed = [list(r) for r in post]
    renamed[1][-1] = (renamed[1][-1][0], "not in the dictionary")
    for wrong in (rescored, renamed):
        assert not serve._same_up_to_ties(pre[40], wrong, 40)
