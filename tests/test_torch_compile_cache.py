"""The port's compile cache against ``repro``'s.

``CompileCache`` and ``bucket_size`` alone (the same calls give the same
counts, entries and errors), then one call sequence through both
packages' ``CompletionIndex`` (``repro`` on its ``"jnp"`` substrate, the
port on the CPU): batches of several bucketed shapes, a widened retry, a
typing session, a scheduler's slab flushes, a mutated batch (the overlay
merge), a ``reconfigure`` (new keys, old entries kept) and a ``compact``
(a fresh cache), with ``hits``/``misses``/``evictions`` compared after
every step; and the sharded index's local cache under its keys.
"""

from functools import lru_cache

import pytest

import repro.api as jax_api
import repro_torch as rt
from repro.core import distributed as jax_dist
from repro.core import make_rules as jax_rules
from repro.serving.completion_service import \
    CompletionService as JaxService
from repro_torch.api import CompileCache, bucket_size
from repro_torch.core.trie_build import make_rules
from torch_fast_jit import fast_jax_jit  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

STRINGS = ["andrew pavlo", "andrew parker", "andrew packard", "andy x",
           "william smith", "bill of rights", "apple", "apply", "banana"]
SCORES = [50, 40, 30, 5, 20, 10, 9, 4, 1]
RULES = [("andy", "andrew"), ("bill", "william")]


@pytest.mark.parametrize("maxsize", [1, 2, 3, 32])
def test_cache_matches_repro(maxsize):
    keys = ["a", "b", "a", "c", ("batch", 8, 8, 3), "b", "d", "a",
            ("batch", 8, 8, 3), "e", "c", "a"]
    ours, theirs = CompileCache(maxsize), jax_api.CompileCache(maxsize)
    for i, key in enumerate(keys):
        assert ours.get(key, lambda: i) == theirs.get(key, lambda: i)
        assert (ours.hits, ours.misses, ours.evictions, len(ours)) == \
            (theirs.hits, theirs.misses, theirs.evictions, len(theirs))
        assert (key in ours) == (key in theirs)
    assert ours.stats() == theirs.stats()
    ours.clear()
    theirs.clear()
    assert ours.stats() == theirs.stats()


@pytest.mark.parametrize("maxsize", [0, -1])
def test_cache_size_must_be_positive(maxsize):
    with pytest.raises(ValueError, match="positive"):
        jax_api.CompileCache(maxsize)
    with pytest.raises(ValueError, match="positive"):
        CompileCache(maxsize)


def test_bucket_size_matches_repro():
    for n in [-3, 0, 1, 2, 3, 7, 8, 9, 31, 32, 33, 100, 1000]:
        for minimum in (1, 8, 16):
            assert bucket_size(n, minimum) == \
                jax_api.bucket_size(n, minimum)


@lru_cache(maxsize=None)
def _indexes(cache_size):
    j = jax_api.build_index(STRINGS, SCORES, jax_rules(RULES),
                            jax_api.IndexSpec(kind="et", cache_k=4,
                                              substrate="jnp"))
    p = rt.build_index(STRINGS, SCORES, make_rules(RULES),
                       rt.IndexSpec(kind="et", cache_k=4), device="cpu")
    for idx in (j, p):
        idx._compile_cache = type(idx._compile_cache)(maxsize=cache_size)
    return j, p


def _stats(idx):
    c = idx._compile_cache
    return c.hits, c.misses, c.evictions, len(c)


def _slab(service_cls, idx):
    """Two sessions' keystrokes through a batching service: slab
    advances and slab top-k flushes."""
    svc = service_cls(idx, batching=True, block=4)
    a, b = svc.open_session(k=2), svc.open_session(k=2)
    tickets = [a.submit("a"), b.submit("b"), a.submit("n")]
    svc.drain()
    return [t.results for t in tickets]


def _mutated(idx):
    idx.insert("andes", 60)
    idx.delete("apple")
    return idx.complete(["an", "ap"], k=3)


def _reconfigured(idx):
    idx.reconfigure(frontier=16)
    first = idx.complete(["a", "bi"], k=3)
    idx.reconfigure(frontier=32)
    return first, idx.complete(["a", "bi"], k=3)


def _compacted(idx):
    idx.compact()
    return idx.complete(["a", "bi"], k=3)


STEPS = [
    ("two buckets", lambda idx, svc: [idx.complete(["a", "bi"], k=3),
                                      idx.complete(["andrew pa"] * 9,
                                                   k=3)]),
    ("the same buckets again", lambda idx, svc: [
        idx.complete(["b", "w"], k=3), idx.complete(["a"] * 12, k=3)]),
    ("k past the cache (the beam)", lambda idx, svc: idx.complete(
        ["a", "andy pa"], k=6)),
    ("a session", lambda idx, svc: idx.session(k=3).type("andy")),
    ("a slab", lambda idx, svc: _slab(svc, idx)),
    ("a mutated batch", lambda idx, svc: _mutated(idx)),
    ("a reconfigure", lambda idx, svc: _reconfigured(idx)),
    ("a compact", lambda idx, svc: _compacted(idx)),
]


def test_index_call_sequence_matches_repro():
    # a cache of 4 entries: the sequence evicts, and re-misses keys it
    # evicted
    j, p = _indexes(4)
    evicted = 0
    for name, step in STEPS:
        want = step(j, JaxService)
        got = step(p, rt.CompletionService)
        assert got == want, name
        assert _stats(p) == _stats(j), name
        evicted = max(evicted, _stats(p)[2])
    assert _stats(p)[1] > 0 and evicted > 0


def test_compact_keeps_the_cache_size():
    p = rt.build_index(STRINGS, SCORES, make_rules(RULES), kind="et",
                       device="cpu")
    p._compile_cache = CompileCache(maxsize=5)
    p.complete(["a"], k=2)
    p.insert("andes", 3)
    p.compact()
    assert p._compile_cache.maxsize == 5
    assert _stats(p) == (0, 0, 0, 0)


def test_constructor_takes_the_cache_size():
    p = rt.build_index(STRINGS, SCORES, make_rules(RULES), kind="et",
                       device="cpu")
    q = rt.CompletionIndex(p.spec, p.trie, p.rule_trie, p.rules, p.strings,
                           p.scores, p.cfg, p.stats, device="cpu",
                           compile_cache_size=7)
    assert q._compile_cache.maxsize == 7
    assert p._compile_cache.maxsize == 32


def test_sharded_local_cache_matches_repro():
    j = jax_dist.ShardedCompletionIndex(STRINGS, SCORES, jax_rules(RULES),
                                        n_shards=3, kind="et",
                                        substrate="jnp")
    p = rt.ShardedCompletionIndex(STRINGS, SCORES, make_rules(RULES),
                                  n_shards=3, kind="et", device="cpu")
    for queries, k in ((["a", "b"], 3), (["and"] * 11, 3), (["w"], 3)):
        assert p.complete(queries, k) == j.complete(queries, k)
        pc, jc = p._local_cache, j._local_cache
        assert (pc.maxsize, pc.hits, pc.misses, pc.evictions) == \
            (jc.maxsize, jc.hits, jc.misses, jc.evictions)
        # the keys are (B, L, k, cfg); the configs differ by substrate
        assert {key[:3] for key in pc._entries} == \
            {key[:3] for key in jc._entries}
