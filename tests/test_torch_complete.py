"""``CompletionIndex.complete`` end to end: the port on the CPU against the
JAX package (``substrate="jnp"``) and against ``repro.core.oracle``.

The same corpora and queries go through both packages; answers are
(score, string) lists, compared exactly.  The oracle ranks equal scores by
string, the engines by emission order, so against the oracle the scores
are compared in order and the strings as sets per score.
"""

import pytest
import torch

import repro_torch as rt
from repro.api import IndexSpec as JaxSpec
from repro.api import build_index as jax_build
from repro.core import make_rules
from repro.core.oracle import OracleIndex
from repro.data.strings import make_dblp, make_usps, make_workload
from repro_torch.core.alphabet import pad_queries
from repro_torch.core.engine import beam, locus
from repro_torch.core.engine.substrate import complete_batch
from repro_torch.kernels import beam_topk, locus_dp, trie_walk
from torch_fast_jit import fast_jax_jit  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

KINDS = ["plain", "tt", "et", "ht"]
PAPER = (["andrew pavlo", "andrew parker", "andrew packard", "william smith",
          "bill of rights"], [50, 40, 30, 20, 10],
         [("andy", "andrew"), ("bill", "william")])
# a rewritten query, a plain prefix, the empty prefix, an unmatched query,
# a query longer than its match, and one past the L bucket of 8
PAPER_QUERIES = ["andy pa", "andrew pa", "bil", "bill of", "a", "",
                 "xyz", "andy pavloz", "william smith", "w"]
STARVED = dict(frontier=2, gens=2, expand=2, max_steps=4)


def _rules(rules, kind):
    return make_rules(rules) if kind != "plain" else []


def _port(data, kind, **kw):
    strings, scores, rules = data
    return rt.build_index(strings, scores, _rules(rules, kind),
                          rt.IndexSpec(kind=kind, **kw), device="cpu")


def _jax(data, kind, **kw):
    strings, scores, rules = data
    return jax_build(strings, scores, _rules(rules, kind),
                     JaxSpec(kind=kind, substrate="jnp", **kw))


def _assert_matches_oracle(data, kind, queries, rows, k):
    strings, scores, rules = data
    oracle = OracleIndex(strings, scores, _rules(rules, kind))
    for q, row in zip(queries, rows):
        want = oracle.complete(q, k)
        assert [s for s, _ in row] == [s for s, _ in want], q
        for score in {s for s, _ in want}:
            got = {x for s, x in row if s == score}
            exp = {x.decode() for s, x in want if s == score}
            # a tie cut by k may keep different strings, never others
            assert got <= {x.decode() for x in oracle.matches(q)}, q
            if sum(1 for s, _ in want if s == score) == \
                    sum(1 for s, _ in oracle.complete(q, 10**6)
                        if s == score):
                assert got == exp, q


@pytest.mark.parametrize("kind", KINDS)
def test_complete_matches_repro_and_oracle(kind):
    port = _port(PAPER, kind)
    rows = port.complete(PAPER_QUERIES, k=3)
    assert rows == _jax(PAPER, kind).complete(PAPER_QUERIES, k=3)
    _assert_matches_oracle(PAPER, kind, PAPER_QUERIES, rows, 3)
    assert rows[PAPER_QUERIES.index("")] != []        # the empty prefix
    assert rows[PAPER_QUERIES.index("xyz")] == []     # unmatched


def test_widened_retry_matches_repro():
    """A one-wide frontier (overflow) and a short step cap force the
    inexact flag; the widened host-side retry must converge to the same
    answers as the JAX package's."""
    starved = dict(frontier=1, max_steps=5)
    rows = _port(PAPER, "et", **starved).complete(PAPER_QUERIES, k=3)
    assert rows == _jax(PAPER, "et", **starved).complete(PAPER_QUERIES, k=3)
    assert rows == _port(PAPER, "et").complete(PAPER_QUERIES, k=3)


@pytest.mark.parametrize("kind", KINDS)
def test_widened_retry_matches_wide_and_oracle(kind):
    """The retry really runs (the first pass is inexact) and lands on the
    wide answers."""
    tiny = _port(PAPER, kind, **STARVED)
    qs, ql = pad_queries(PAPER_QUERIES, 16)
    _, _, exact = complete_batch(tiny.tensors, tiny.cfg, torch.from_numpy(qs),
                                 torch.from_numpy(ql), 3)
    assert not exact.all()
    rows = tiny.complete(PAPER_QUERIES, k=3)
    assert rows == _port(PAPER, kind).complete(PAPER_QUERIES, k=3)
    _assert_matches_oracle(PAPER, kind, PAPER_QUERIES, rows, 3)


CORPUS_CASES = [("usps", k) for k in KINDS] + \
    [("dblp", k) for k in ("plain", "tt", "et")]


@pytest.mark.parametrize("corpus,kind", CORPUS_CASES)
def test_corpus_complete_matches_oracle(corpus, kind):
    ds = make_usps(150, seed=4) if corpus == "usps" else make_dblp(120, seed=5)
    data = (ds.strings, ds.scores, ds.rules)
    queries = make_workload(ds, 11, seed=6) + ["", "qqq"]
    port = _port(data, kind)
    rows = port.complete(queries, k=4)
    _assert_matches_oracle(data, kind, queries, rows, 4)
    # the cuda substrate's routing, answered by the plain versions on CPU
    assert port.reconfigure(substrate="cuda").complete(queries, k=4) == rows


def test_non_power_of_two_batches():
    port = _port(PAPER, "et")
    full = port.complete(PAPER_QUERIES, k=2)
    for n in (1, 3, 5, 7):
        assert port.complete(PAPER_QUERIES[:n], k=2) == full[:n]
    assert port.complete([], k=2) == []


def test_service_complete_and_stats():
    service = rt.CompletionService(_port(PAPER, "ht"))
    rows = service.complete(PAPER_QUERIES[:4], k=2)
    assert rows == _port(PAPER, "ht").complete(PAPER_QUERIES[:4], k=2)
    service.complete(PAPER_QUERIES[4:], k=2)
    st = service.stats
    assert (st.n_queries, st.batches) == (len(PAPER_QUERIES), 2)
    assert len(st.latencies_ms) == len(PAPER_QUERIES)
    assert 0 < st.p50_latency_ms <= st.p99_latency_ms
    service.reset_stats()
    assert service.stats.n_queries == 0


def test_cpu_main_path_runs_only_plain_versions():
    """On the CPU the torch substrate runs the plain versions and no
    kernel wrapper launches anything."""
    before = (trie_walk.launches, locus_dp.launches, beam_topk.launches,
              locus.calls, beam.calls)
    _port(PAPER, "tt").complete(PAPER_QUERIES, k=3)
    after = (trie_walk.launches, locus_dp.launches, beam_topk.launches,
             locus.calls, beam.calls)
    assert after[:3] == before[:3]
    assert after[3] > before[3] and after[4] > before[4]
