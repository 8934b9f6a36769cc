"""The cached phase 2 (``cache_k > 0``) in the port against the JAX package.

The plain versions of the two selection kernels — ``topk_select`` (top-k
with a payload) and ``locus_topk_merge`` (per-node top-K gather + merge)
— are held against ``repro.kernels.ref`` on seeded inputs with heavy
ties, ``k == C``, ``k >= F*K`` and all-empty rows; the packed cache decode
against ``repro.core.engine.packed.gather_cached``; ``complete`` on cached
indexes of both layouts against ``repro`` (jnp), the dense port index and
the oracle, with ``k > cache_k`` (the beam) and a forced retry (the cache
turned off); and containers with a cache saved by ``repro``.  Every
output is an integer, so equality is exact.
"""

from functools import lru_cache
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch as rt
from repro.api import IndexSpec as JaxSpec
from repro.api import build_index as jax_build
from repro.core import make_rules
from repro.core.engine import packed as jpk
from repro.core.oracle import OracleIndex
from repro.data.strings import make_usps, make_workload
from repro.kernels import ref as jref
from repro_torch.core.alphabet import pad_queries
from repro_torch.core.engine import cached
from repro_torch.core.engine import packed as pk
from repro_torch.core.engine.substrate import complete_batch, get_substrate
from repro_torch.kernels import locus_merge, ref as tref, topk_select
from torch_fast_jit import fast_jax_jit  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

KINDS = ["plain", "tt", "et", "ht"]
NEG = -(2**31 - 1)


def _np_equal(a, b):
    np.testing.assert_array_equal(np.asarray(a), b.numpy())


# -- the two selections -------------------------------------------------------

SELECT_CASES = [  # (B, C, k, score range): ties, k == C, wide rows
    (8, 16, 10, (0, 3)), (8, 16, 16, (0, 3)), (4, 5, 1, (-1, 1)),
    (64, 512, 10, (0, 40)), (3, 7, 7, (NEG, 2**31 - 1))]


@pytest.mark.parametrize("B,C,k,rng_", SELECT_CASES)
def test_topk_select_plain_matches_repro(B, C, k, rng_):
    rng = np.random.default_rng(C * 31 + k)
    scores = rng.integers(rng_[0], rng_[1], (B, C), dtype=np.int64)
    scores = scores.astype(np.int32)
    if rng_[0] == NEG:
        scores[:, :2] = NEG                    # the kernels' mask value
    payload = rng.integers(-1, 1000, (B, C)).astype(np.int32)
    want = jref.topk_select_ref(jnp.asarray(scores), jnp.asarray(payload), k)
    got = tref.topk_select_ref(torch.from_numpy(scores),
                               torch.from_numpy(payload), k)
    for a, b in zip(want, got):
        _np_equal(a, b)
    wrapped = topk_select.topk_select(torch.from_numpy(scores),
                                      torch.from_numpy(payload), k)
    assert all(torch.equal(a, b) for a, b in zip(wrapped, got))


def test_topk_select_rejects_k_above_c():
    s = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="k <= C"):
        topk_select.topk_select(s, s, 5)


def _dense_cache(rng, n, K, hi):
    """A seeded [n, K] cache: score-sorted rows, -1 padded, heavy ties."""
    score = np.sort(rng.integers(-1, hi, (n, K)), axis=1)[:, ::-1]
    score = np.ascontiguousarray(score).astype(np.int32)
    sid = np.where(score >= 0, rng.integers(0, 10**4, (n, K)), -1)
    return score, sid.astype(np.int32)


MERGE_CASES = [(16, 4, 4, 3), (16, 4, 4, 16), (8, 32, 16, 10),
               (8, 3, 4, 12)]   # (B, F, K, k): k == F*K and k > F*K


@pytest.mark.parametrize("B,F,K,k", MERGE_CASES)
def test_cached_merge_plain_matches_repro(B, F, K, k):
    """Heavy ties, all-empty rows and ``k >= F*K`` (the whole union
    sorted, then -1 padding, as ``repro.kernels.ops.cached_topk_merge``)."""
    rng = np.random.default_rng(B + F + K + k)
    score, sid = _dense_cache(rng, 40, K, 4)
    loci = rng.integers(-1, 40, (B, F)).astype(np.int32)
    loci[0] = -1                                  # an all-empty row
    loci[1, : F // 2] = loci[1, F // 2:][: F // 2]  # duplicate loci
    width = min(k, F * K)
    want = jref.cached_topk_merge_ref(jnp.asarray(loci), jnp.asarray(score),
                                      jnp.asarray(sid), width)
    t = SimpleNamespace(p_labels=None, topk_score=torch.from_numpy(score),
                        topk_sid=torch.from_numpy(sid))
    got = locus_merge.locus_topk_merge(t, torch.from_numpy(loci), k)
    for a, b in zip(want, got):
        _np_equal(a, b[:, :width])
        assert (b[:, width:] == -1).all()
    if k <= F * K:
        ref = tref.cached_topk_merge_ref(torch.from_numpy(loci),
                                         torch.from_numpy(score),
                                         torch.from_numpy(sid), k)
        assert all(torch.equal(a, b) for a, b in zip(ref, got))
    assert (got[0][0] == -1).all() and (got[1][0] == -1).all()


# -- cached indexes ---------------------------------------------------------------


@lru_cache(maxsize=1)
def _usps():
    ds = make_usps(300, seed=4)
    queries = make_workload(ds, 11, seed=6) + ["", "qqq"]
    return ds.strings, ds.scores, ds.rules, queries


def _rules(rules, kind):
    return make_rules(rules) if kind != "plain" else []


def _port(kind, **kw):
    strings, scores, rules, _ = _usps()
    return rt.build_index(strings, scores, _rules(rules, kind),
                          rt.IndexSpec(kind=kind, **kw), device="cpu")


def _jax(kind, **kw):
    strings, scores, rules, _ = _usps()
    return jax_build(strings, scores, _rules(rules, kind),
                     JaxSpec(kind=kind, substrate="jnp", **kw))


@pytest.mark.parametrize("kind", ["tt", "et"])
def test_packed_cache_decode_matches_repro(kind):
    """The quantized cache decoded at the read equals ``repro``'s decode
    and the dense cache rows of the same nodes (node ids are shared)."""
    j = _jax(kind, cache_k=4, compression="packed")
    p = _port(kind, cache_k=4, compression="packed")
    dense = _port(kind, cache_k=4)
    rng = np.random.default_rng(7)
    loci = rng.integers(-1, p.trie.n_nodes, (12, 6)).astype(np.int32)
    # loci are dict nodes: synonym nodes never survive the walk
    loci = np.where(np.asarray(dense.trie.syn_mask)[np.maximum(loci, 0)],
                    -1, loci).astype(np.int32)
    want = jpk.gather_cached(j.device, jnp.asarray(loci))
    got = pk.gather_cached(p.tensors, torch.from_numpy(loci))
    for a, b in zip(want, got):
        _np_equal(a, b)
    d = cached.gather_cached(dense.tensors, torch.from_numpy(loci))
    assert all(torch.equal(a, b) for a, b in zip(got, d))
    m_p = locus_merge.locus_merge_plain(p.tensors, torch.from_numpy(loci), 6)
    m_d = locus_merge.locus_merge_plain(dense.tensors,
                                        torch.from_numpy(loci), 6)
    assert all(torch.equal(a, b) for a, b in zip(m_p, m_d))


def _assert_matches_oracle(kind, queries, rows, k):
    strings, scores, rules, _ = _usps()
    oracle = OracleIndex(strings, scores, _rules(rules, kind))
    for q, row in zip(queries, rows):
        assert [s for s, _ in row] == [s for s, _ in oracle.complete(q, k)], q
        assert {x for _, x in row} <= {x.decode() for x in
                                       oracle.matches(q)}, q


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("compression", ["none", "packed"])
def test_cached_complete_matches_dense_and_oracle(kind, compression):
    """k <= cache_k takes the cache, k > cache_k the beam; both layouts
    answer alike and as the oracle; the cuda substrate's routing
    (answered by the plain versions here) agrees."""
    queries = _usps()[3]
    idx = _port(kind, cache_k=4, compression=compression)
    dense = _port(kind, cache_k=4)
    for k in (3, 6):
        rows = idx.complete(queries, k=k)
        assert rows == dense.complete(queries, k=k)
        _assert_matches_oracle(kind, queries, rows, k)
    assert idx.reconfigure(substrate="cuda").complete(queries, k=3) == \
        dense.complete(queries, k=3)


@pytest.mark.parametrize("compression", ["none", "packed"])
def test_cached_complete_matches_repro(compression):
    queries = _usps()[3]
    j = _jax("et", cache_k=4, compression=compression)
    p = _port("et", cache_k=4, compression=compression)
    assert p.complete(queries, k=3) == j.complete(queries, k=3)


@pytest.mark.parametrize("compression", ["none", "packed"])
def test_forced_retry_turns_the_cache_off(compression):
    """A starved frontier overflows, so the first (cached) pass is
    inexact; the widened rounds run the beam with the cache off and land
    on the wide answers."""
    queries = _usps()[3]
    starved = _port("et", cache_k=4, compression=compression, frontier=1,
                    gens=2, expand=1, max_steps=4)
    qs, ql = pad_queries(queries, 16)
    before = (cached.calls, cached.select_calls)
    _, _, exact = complete_batch(starved.tensors, starved.cfg,
                                 torch.from_numpy(qs), torch.from_numpy(ql),
                                 3)
    assert not exact.all()
    assert cached.calls == before[0] + 1       # the first pass was cached
    rows = starved.complete(queries, k=3)
    assert rows == _port("et", cache_k=4).complete(queries, k=3)
    _assert_matches_oracle("et", queries, rows, 3)


@pytest.mark.parametrize("compression", ["none", "packed"])
def test_load_repro_cached_container(tmp_path, compression):
    j = _jax("tt", cache_k=4, compression=compression)
    p = _port("tt", cache_k=4, compression=compression)
    path = str(tmp_path / "cached.npz")
    j.save(path)
    q = rt.load_index(path, device="cpu")
    assert q.cfg.use_cache and q.cfg.cache_k == 4
    for name in ("topk_score", "topk_sid", "pc_score", "pc_base", "pc_sid"):
        a, b = getattr(j.device, name), getattr(q.tensors, name)
        if a is None:
            assert b is None, name
        else:
            assert np.asarray(a).dtype == b.numpy().dtype, name
            _np_equal(a, b)
    queries = _usps()[3]
    assert q.complete(queries, k=3) == p.complete(queries, k=3)


@pytest.mark.parametrize("kind,compression,route", [
    ("plain", "none", "select"), ("tt", "none", "merge"),
    ("plain", "packed", "merge"), ("ht", "packed", "merge")])
def test_cuda_substrate_cached_routing(kind, compression, route):
    """The cuda substrate's cached phase 2: a dense rule-free index selects
    from each locus's own row (``topk_select``), everything else merges
    (``locus_topk_merge``); on CPU tensors the wrappers answer with their
    plain versions and launch nothing."""
    idx = _port(kind, cache_k=4, compression=compression)
    queries = _usps()[3]
    qs, ql = pad_queries(queries, 16)
    loci, _ = get_substrate("torch").walk_batch(
        idx.tensors, idx.cfg, torch.from_numpy(qs), torch.from_numpy(ql))
    before = (cached.select_calls, cached.calls, topk_select.launches,
              locus_merge.launches)
    got = get_substrate("cuda").cached_topk_batch(idx.tensors, idx.cfg,
                                                  loci, 3)
    after = (cached.select_calls, cached.calls, topk_select.launches,
             locus_merge.launches)
    assert after[2:] == before[2:]
    assert after[1] - before[1] == (route == "merge")
    want = get_substrate("torch").cached_topk_batch(idx.tensors, idx.cfg,
                                                    loci, 3)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError, match="cache_k"):
        get_substrate("cuda").cached_topk_batch(idx.tensors, idx.cfg, loci,
                                                5)


def test_service_on_cached_packed_index():
    idx = _port("ht", cache_k=4, compression="packed")
    queries = _usps()[3]
    service = rt.CompletionService(idx)
    assert service.complete(queries, k=3) == idx.complete(queries, k=3)
    assert service.stats.n_queries == len(queries)
