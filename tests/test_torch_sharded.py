"""The sharded index in local mode: the port's ``ShardedCompletionIndex``
on the CPU against ``repro.core.distributed`` (``substrate="jnp"``), the
unsharded index and ``repro.core.oracle``.

Both packages hash-partition one corpus into the same shards; the stacked
tables and the merged config must be equal, array for array, and the
answers equal in scores, strings and order.  Against the oracle and the
unsharded index the scores are compared in order and the strings as sets
of the dictionary (ties across shards go to the lower shard, not the
lower string).  ``tests/test_torch_sharded_rules.py`` continues this file
with these helpers: the rule-bearing kinds' answers, ``repro``'s absence
of a widened retry, the two faults of ``repro``'s sharded mode that the
port repairs, save and load, and the targeted errors.
"""

from functools import lru_cache

import numpy as np
import pytest
import torch

import repro_torch as rt
from repro.core import engine as jax_eng
from repro.core import make_rules as jax_rules
from repro.core import distributed as jax_dist
from repro.core.oracle import OracleIndex
from repro.data.strings import make_usps, make_workload
from repro_torch.core import distributed as dist
from repro_torch.core.engine import substrate as subs
from repro_torch.core.trie_build import make_rules
from torch_fast_jit import fast_jax_jit  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

K_SMALL, K_BIG, CACHE_K = 3, 6, 4
# the small corpus: repro's sharded jit compiles a (batch, length, k,
# config) shape in ~2-16 s here, fewer with fewer rule steps; scores with
# ties across shards
SMALL = ([f"record {i:03d} entry" for i in range(64)]
         + ["andrew pavlo", "william smith", "bill of rights", "andy x"],
         [(i * 7) % 23 + 1 for i in range(68)],
         [("andy", "andrew"), ("bill", "william"), ("rec", "record")],
         ["andy", "bill s", "rec 00", "record 0", "zzz", "entry", "r", "",
          "andy pa", "bill", "w", "a"])


@lru_cache(maxsize=None)
def _corpus(name):
    if name == "small":
        return SMALL
    ds = make_usps(300, seed=0)
    # eight bytes at most (one length bucket), the empty prefix and an
    # unmatched query
    qs = [q[:8] for q in make_workload(ds, 13, seed=1)] + ["", "zzz"]
    return ds.strings, ds.scores, ds.rules, qs


def _rules(pkg, rules, kind):
    return [] if kind == "plain" else (jax_rules if pkg == "jax"
                                       else make_rules)(rules)


@lru_cache(maxsize=None)
def _jax(corpus, n_shards, kind, cache_k, frontier=32):
    strings, scores, rules, _ = _corpus(corpus)
    return jax_dist.ShardedCompletionIndex(
        strings, scores, _rules("jax", rules, kind), n_shards=n_shards,
        kind=kind, cache_k=cache_k, frontier=frontier, substrate="jnp")


@lru_cache(maxsize=None)
def _port(corpus, n_shards, kind, cache_k, frontier=32, substrate="torch"):
    strings, scores, rules, _ = _corpus(corpus)
    return rt.ShardedCompletionIndex(
        strings, scores, _rules("port", rules, kind), n_shards=n_shards,
        kind=kind, cache_k=cache_k, frontier=frontier, substrate=substrate,
        device="cpu")


def _assert_like_oracle(strings, scores, rules, queries, rows, k):
    """Scores in order equal to the oracle's; every string a dictionary
    string the query matches, each score's strings the oracle's where k
    does not cut that score's tie."""
    oracle = OracleIndex(strings, scores, rules)
    for q, row in zip(queries, rows):
        want = oracle.complete(q, k)
        assert [s for s, _ in row] == [s for s, _ in want], q
        matches = {x.decode() for x in oracle.matches(q)}
        for score in {s for s, _ in want}:
            got = {x for s, x in row if s == score}
            assert got <= matches, q
            if sum(s == score for s, _ in want) == sum(
                    s == score for s, _ in oracle.complete(q, 10**6)):
                assert got == {x.decode() for s, x in want if s == score}, q


# -- stacking --------------------------------------------------------------

STACK_CASES = [("usps", 16, "et", CACHE_K), ("usps", 3, "tt", 0),
               ("usps", 1, "plain", CACHE_K), ("small", 3, "ht", CACHE_K),
               ("small", 16, "tt", 0)]


@pytest.mark.parametrize("corpus,n_shards,kind,cache_k", STACK_CASES)
def test_stack_shards_equals_repro(corpus, n_shards, kind, cache_k):
    """The same shards, the same stacked arrays (names, shapes, dtypes,
    values), merged config and stride; per-shard views of them."""
    jx = _jax(corpus, n_shards, kind, cache_k)
    port = _port(corpus, n_shards, kind, cache_k)
    stacked, cfg, stride = jax_dist.stack_shards(jx.shards)
    assert port.stride == stride
    assert [list(s) for s in port.shard_strings] == \
        [list(s.strings) for s in jx.shards]
    for f in jax_eng.DeviceTrie._fields:
        want = getattr(stacked, f)
        got = getattr(port.tensors, f)
        if want is None:
            assert got is None, f
            continue
        assert got.numpy().dtype == np.asarray(want).dtype, f
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), f)
    assert port.tensors.c_tree is None
    want_cfg = {k: v for k, v in vars(cfg).items() if k != "substrate"}
    got_cfg = {k: v for k, v in vars(port.cfg).items() if k in want_cfg}
    assert got_cfg == want_cfg and set(want_cfg) <= set(vars(port.cfg))
    assert port.cfg.substrate == "torch"
    for s, view in enumerate(port.shard_tries):
        for x, whole in zip(view, port.tensors):
            if x is not None:
                assert x.is_contiguous()
                assert x.data_ptr() == whole[s].data_ptr()


def test_pad_shard_equals_the_stacked_slice():
    """The mesh path's per-rank padding gives that shard's stacked slice."""
    port = _port("small", 3, "ht", CACHE_K)
    shapes = [dist._shapes(ix.tensors) for ix in port.shards]
    targets = dist.target_shapes(shapes, [ix.cfg for ix in port.shards])
    for s, ix in enumerate(port.shards):
        padded = dist.pad_shard(ix.tensors, targets)
        for x, whole in zip(padded, port.tensors):
            assert (x is None) == (whole is None)
            if x is not None:
                assert torch.equal(x, whole[s])


# -- the merge --------------------------------------------------------------


@pytest.mark.parametrize("substrate", ["torch", "cuda"])
def test_merge_shard_topk_equals_repro(substrate):
    """Random [S, B, k] answers full of ties: the same global top-k and
    payload as repro's merge (ties to the lower shard, then rank)."""
    rng = np.random.default_rng(3)
    S, B, k = 5, 7, 6
    scores = -np.sort(-rng.integers(-1, 6, (S, B, k)), axis=-1)
    gsids = rng.integers(0, 10_000, (S, B, k))
    scores, gsids = scores.astype(np.int32), gsids.astype(np.int32)
    got = dist.merge_shard_topk(torch.from_numpy(scores),
                                torch.from_numpy(gsids), k,
                                subs.get_substrate(substrate))
    want = jax_dist.merge_shard_topk(scores, gsids, k,
                                     jax_eng.get_substrate("jnp"))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# -- answers ----------------------------------------------------------------

# (n_shards, kind, cache_k, ks): every shard count, kind and cache depth,
# k below and above cache_k, each against repro on the small corpus (a
# compile of repro's 16-shard jit costs ~16 s, of a rule-bearing kind's
# ~10 s, so each case runs few)
# (the rule-bearing kinds at 3 shards, tt and ht, are the same test's
# cases in tests/test_torch_sharded_rules.py: one file would take longer
# than a minute)
ANSWER_CASES = [
    (1, "et", CACHE_K, (K_SMALL,)),
    (3, "plain", CACHE_K, (K_SMALL,)),
    (16, "et", CACHE_K, (K_SMALL,)),
]


@pytest.mark.parametrize("n_shards,kind,cache_k,ks", ANSWER_CASES)
def test_answers_equal_repro_and_oracle(n_shards, kind, cache_k, ks):
    check_answers(n_shards, kind, cache_k, ks)


def check_answers(n_shards, kind, cache_k, ks):
    """The sharded answers at each k against repro's local mode, the
    oracle's scores and the unsharded index's scores; no shard answer
    inexact."""
    strings, scores, rules, qs = _corpus("small")
    port = _port("small", n_shards, kind, cache_k)
    single = rt.build_index(strings, scores, _rules("port", rules, kind),
                            kind=kind, cache_k=cache_k, device="cpu")
    for k in ks:
        rows = port.complete(qs, k=k)
        assert rows == _jax("small", n_shards, kind, cache_k).complete(
            qs, k=k), k
        _assert_like_oracle(strings, scores, _rules("jax", rules, kind), qs,
                            rows, k)
        assert [[s for s, _ in r] for r in rows] == \
            [[s for s, _ in r] for r in single.complete(qs, k=k)]
    assert port.inexact == 0


@pytest.mark.parametrize("corpus,n_shards,kind", [
    ("small", 16, "et"), ("usps", 3, "plain"), ("small", 3, "ht")])
def test_cuda_routing_equals_torch_and_oracle(corpus, n_shards, kind):
    """The "cuda" substrate's routing (its wrappers answer CPU tensors with
    their plain versions) over the stacked shards: the torch substrate's
    answers at k below and above cache_k, the oracle's scores."""
    strings, scores, rules, qs = _corpus(corpus)
    cuda = _port(corpus, n_shards, kind, CACHE_K, substrate="cuda")
    assert cuda.cfg.substrate == "cuda"
    for k in (K_SMALL, K_BIG):
        rows = cuda.complete(qs, k=k)
        assert rows == _port(corpus, n_shards, kind, CACHE_K).complete(qs,
                                                                        k=k)
        _assert_like_oracle(strings, scores, _rules("jax", rules, kind), qs,
                            rows, k)


def test_views_made_once():
    """The per-shard views are made at construction and reused by every
    batch (the kernels cache their table checks by tensor identity)."""
    port = _port("small", 3, "tt", CACHE_K)
    before = [[id(x) for x in t] for t in port.shard_tries]
    _, _, _, qs = _corpus("small")
    port.complete(qs[:3], k=K_SMALL)
    port.complete(qs, k=K_BIG)
    assert [[id(x) for x in t] for t in port.shard_tries] == before


def test_service_serves_batches():
    _, _, _, qs = _corpus("small")
    port = _port("small", 3, "ht", 0)
    svc = rt.CompletionService(port)
    assert svc.complete(qs, k=K_SMALL) == port.complete(qs, k=K_SMALL)
    assert svc.stats.n_queries == len(qs)
