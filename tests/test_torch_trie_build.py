"""The port's host build steps that differ in method from the JAX
package's, against it.

``build_topk_cache`` copies a child's row into a parent that nothing has
been written to yet instead of sorting the two, and ``rebuild_edges``
sorts on one combined integer key instead of ``np.lexsort``.  Both must
leave every host array equal to ``repro``'s.  The corpora are those where
an order could slip: every score equal and scores of three values (ties
decide the order), short random byte strings (branching everywhere, long
unary chains nowhere), synonym expansion (et, ht), and cache depths 1, 4
and 16.  Everything is an integer, so equality is exact.
"""

import dataclasses

import numpy as np
import pytest

import repro_torch as rt
from repro.api import IndexSpec as JaxSpec
from repro.api import build_index as jax_build
from repro.core import make_rules
from repro.data.strings import make_usps
from repro_torch.core import trie_build as ptb
from torch_threads import one_torch_thread  # noqa: F401

N = 1_500


def _corpus(name):
    ds = make_usps(N, seed=3)
    if name == "usps":
        return ds.strings, ds.scores, ds.rules
    if name == "equal":
        return ds.strings, np.full(N, 7), ds.rules
    if name == "three":
        return ds.strings, np.random.default_rng(5).choice([5, 9, 13], N), \
            ds.rules
    rng = np.random.default_rng(7)   # "bytes": short random byte strings
    strings = sorted({bytes(rng.integers(97, 101, rng.integers(1, 7)))
                      .decode() for _ in range(N)})
    return strings, rng.integers(0, 4, len(strings)), []


@pytest.mark.parametrize("corpus,kind,cache_k", [
    ("usps", "et", 16), ("usps", "ht", 4), ("usps", "plain", 1),
    ("equal", "et", 16), ("equal", "plain", 4), ("three", "et", 4),
    ("three", "tt", 16), ("bytes", "plain", 16), ("bytes", "plain", 1)])
def test_host_arrays_equal_repro(corpus, kind, cache_k):
    strings, scores, rules = _corpus(corpus)
    rules = make_rules(rules) if kind != "plain" else []
    j = jax_build(strings, scores, rules,
                  JaxSpec(kind=kind, cache_k=cache_k, substrate="jnp"))
    p = rt.build_index(strings, scores, rules,
                       rt.IndexSpec(kind=kind, cache_k=cache_k),
                       device="cpu")
    assert p.trie.topk_score is not None
    for f in dataclasses.fields(ptb.DictTrie):
        a, b = getattr(j.trie, f.name), getattr(p.trie, f.name)
        if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


def test_order2_is_lexsort():
    rng = np.random.default_rng(11)
    major = rng.integers(0, 50, 5_000).astype(np.int32)
    for minor in (rng.integers(0, 4, 5_000),
                  rng.integers(-2**31, 2**31 - 1, 5_000)):
        minor = minor.astype(np.int32)
        np.testing.assert_array_equal(ptb._order2(major, minor),
                                      np.lexsort((minor, major)))
