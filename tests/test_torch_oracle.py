"""The port's ``OracleIndex`` (``repro_torch.core.oracle``) against
``repro``'s: random dictionaries, rule sets and query streams from the
shared hypothesis strategies (``tests/strategies.py``), edit budgets 0-2,
through ``complete``, ``topk_scores`` and ``matches``; the paper's example
by hand; and the port's index on the CPU against its own oracle.  Both
oracles are pure Python, so every answer must be equal."""

import pytest

import repro_torch as rt
import strategies as strat
from repro.core import make_rules as jax_rules
from repro.core.oracle import OracleIndex as JaxOracle
from repro_torch.core import OracleIndex
from repro_torch.core.trie_build import make_rules
from strategies import given, settings, st
from torch_threads import one_torch_thread  # noqa: F401

PAPER = (["andrew pavlo", "andrew parker", "andrew packard",
          "william smith", "bill of rights"], [50, 40, 30, 20, 10],
         [("andy", "andrew"), ("bill", "william")])


def _both(strings, scores, rules, e):
    return (OracleIndex(strings, scores, make_rules(rules), edit_budget=e),
            JaxOracle(strings, scores, jax_rules(rules), edit_budget=e))


def _agree(ours, theirs, queries, k):
    for q in queries:
        assert ours.complete(q, k) == theirs.complete(q, k), q
        assert ours.topk_scores(q, k) == theirs.topk_scores(q, k), q
        assert ours.matches(q) == theirs.matches(q), q


@pytest.mark.parametrize("e", [0, 1, 2])
def test_paper_example(e):
    ours, theirs = _both(*PAPER, e)
    _agree(ours, theirs, ["andy pa", "bill sm", "andrw", "wiliam", "",
                          "xyz", b"andrew"], 3)
    if e == 0:
        assert ours.complete("andy pa", 3) == [
            (50, b"andrew pavlo"), (40, b"andrew parker"),
            (30, b"andrew packard")]


@pytest.mark.parametrize("e", [0, 1])
def test_port_index_agrees_with_its_oracle(e):
    ours, _ = _both(*PAPER, e)
    idx = rt.build_index(PAPER[0], PAPER[1], make_rules(PAPER[2]),
                         kind="et", edit_budget=e, device="cpu")
    for q in ["andy pa", "bill sm", "andrw pa", "a", ""]:
        assert [s for s, _ in idx.complete([q], k=5)[0]] == \
            ours.topk_scores(q, 5), q


if strat.HAVE_HYPOTHESIS:
    @settings(max_examples=40, deadline=None, derandomize=True)
    @given(strat.dictionaries, strat.rule_sets, strat.edit_query_streams,
           strat.topk_values, strat.score_seeds, st.integers(0, 2))
    def test_oracles_agree(words, rules, queries, k, seed, e):
        scores = [(seed >> (i % 24)) % 97 + 1 for i in range(len(words))]
        ours, theirs = _both(words, scores, rules, e)
        _agree(ours, theirs, queries, k)
else:
    @strat.needs_hypothesis
    def test_oracles_agree():
        pass
