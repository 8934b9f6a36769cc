"""The sharded index in local mode: the port's ``ShardedCompletionIndex``
on the CPU against ``repro.core.distributed`` (``substrate="jnp"``), the
unsharded index and ``repro.core.oracle``.

Both packages hash-partition one corpus into the same shards; the stacked
tables and the merged config must be equal, array for array, and the
answers equal in scores, strings and order, with ``repro``'s absence of a
widened retry kept.  Two faults of ``repro``'s sharded mode are repaired
in the port and pinned here: a multi-byte query padded by characters,
and the ``(1, '')`` answer of an empty shard; there the port answers as
the unsharded index and the oracle do.  Against the oracle and the
unsharded index the scores are compared in order and the strings as sets
of the dictionary (ties across shards go to the lower shard, not the
lower string).
"""

import json
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
ANSWER_CASES = [
    (1, "et", CACHE_K, (K_SMALL,)),
    (3, "ht", CACHE_K, (K_SMALL,)),
    (3, "tt", 0, (K_BIG,)),
    (3, "plain", CACHE_K, (K_SMALL,)),
    (16, "et", CACHE_K, (K_SMALL,)),
]


@pytest.mark.parametrize("n_shards,kind,cache_k,ks", ANSWER_CASES)
def test_answers_equal_repro_and_oracle(n_shards, kind, cache_k, ks):
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


def test_no_widened_retry():
    """At frontier 1 some shard answers overflow; like repro, the sharded
    index returns them as they are (and counts them) while the unsharded
    index retries wider."""
    strings, scores, rules, qs = _corpus("small")
    port = _port("small", 2, "et", 0, frontier=1)
    rows = port.complete(qs, k=K_BIG)
    assert rows == _jax("small", 2, "et", 0, frontier=1).complete(qs,
                                                                   k=K_BIG)
    assert port.inexact > 0
    single = rt.build_index(strings, scores, make_rules(rules), kind="et",
                            frontier=1, device="cpu")
    assert [[s for s, _ in r] for r in rows] != \
        [[s for s, _ in r] for r in single.complete(qs, k=K_BIG)]


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


# -- the two faults of repro's sharded mode, repaired ------------------------

UTF8 = (["ééééééééé yes", "éééééééé no", "ééééééééézz"], [1, 9, 5])


def test_multibyte_query_padded_by_bytes():
    """A 9-character, 18-byte query: repro pads by characters and answers
    a shorter prefix; the port answers as the unsharded index."""
    q = ["ééééééééé"]
    single = rt.build_index(*UTF8, [], kind="et", device="cpu")
    want = single.complete(q, k=5)
    assert want == [[(5, "ééééééééézz"), (1, "ééééééééé yes")]]
    port = rt.ShardedCompletionIndex(*UTF8, [], n_shards=2, kind="et",
                                     device="cpu")
    assert port.complete(q, k=5) == want
    jx = jax_dist.ShardedCompletionIndex(*UTF8, [], n_shards=2, kind="et",
                                         substrate="jnp")
    assert jx.complete(q, k=5)[0][0] == (9, "éééééééé no")


def test_empty_shard_answers_nothing(tmp_path):
    """Two strings over four shards: repro answers "" with (1, '') for each
    empty shard; the port as the unsharded index, before and after a save
    and load, and from repro's container too."""
    data = (["apple", "banana"], [5, 3])
    want = [[(5, "apple"), (3, "banana")]]
    port = rt.ShardedCompletionIndex(*data, [], n_shards=4, kind="plain",
                                     device="cpu")
    assert port.empty.count(True) == 2
    assert port.complete([""], k=5) == want == \
        rt.build_index(*data, [], kind="plain", device="cpu").complete(
            [""], k=5)
    jx = jax_dist.ShardedCompletionIndex(*data, [], n_shards=4,
                                         kind="plain", substrate="jnp")
    assert jx.complete([""], k=5) == [want[0] + [(1, ""), (1, "")]]
    port.save(str(tmp_path / "port"))
    assert rt.ShardedCompletionIndex.load(
        str(tmp_path / "port"), device="cpu").complete([""], k=5) == want
    jx.save(str(tmp_path / "jax"))
    from_jax = rt.ShardedCompletionIndex.load(str(tmp_path / "jax"),
                                              device="cpu")
    assert from_jax.empty == port.empty
    assert from_jax.complete([""], k=5) == want
    # same stride and global sids as repro
    assert port.stride == jx.stride == 1


# -- persistence --------------------------------------------------------------


def test_save_load_crosses_both_ways(tmp_path):
    """The port's directory answers in repro as the port does; repro's
    (of the same shards) loads into the port with the same answers."""
    _, _, _, qs = _corpus("small")
    port = _port("small", 3, "plain", CACHE_K)
    want = port.complete(qs, k=K_SMALL)
    port.save(str(tmp_path / "port"))
    meta = json.loads((tmp_path / "port" / "meta.json").read_text())
    assert meta["format_version"] == 1 and meta["n_shards"] == 3
    assert meta["spec"]["substrate"] == "auto"
    loaded_by_jax = jax_dist.ShardedCompletionIndex.load(
        str(tmp_path / "port"))
    assert loaded_by_jax.complete(qs, k=K_SMALL) == want
    _jax("small", 3, "plain", CACHE_K).save(str(tmp_path / "jax"))
    loaded = rt.ShardedCompletionIndex.load(str(tmp_path / "jax"),
                                            device="cpu")
    assert loaded.mesh is None and loaded.spec == port.spec.replace(
        substrate="auto")
    assert loaded.n_shards == 3 and loaded.stride == port.stride
    assert loaded.complete(qs, k=K_SMALL) == want
    for a, b in zip(loaded.tensors, port.tensors):
        assert (a is None and b is None) or torch.equal(a, b)


# -- targeted errors ------------------------------------------------------------


PAPER = (["andrew pavlo", "william smith", "andrew parker"], [5, 4, 3])


def test_construction_errors():
    with pytest.raises(TypeError, match="mesh= .*or n_shards="):
        rt.ShardedCompletionIndex(*PAPER, [], kind="et", device="cpu")
    with pytest.raises(TypeError, match="not both"):
        rt.ShardedCompletionIndex(*PAPER, [], n_shards=2, kind="et",
                                  spec=rt.IndexSpec(), device="cpu")
    with pytest.raises(ValueError, match="unsupported on sharded"):
        rt.ShardedCompletionIndex(*PAPER, [], n_shards=2, kind="et",
                                  compression="packed", device="cpu")
    spec = rt.IndexSpec(kind="et", compression="packed")
    with pytest.raises(ValueError, match="compression='none'"):
        spec.validate_sharded()
    assert spec.validate() is spec   # the unsharded index takes it
    shards = [rt.build_index(PAPER[0][i::2], PAPER[1][i::2], [], spec,
                             device="cpu") for i in range(2)]
    with pytest.raises(ValueError, match="compression='none'"):
        rt.ShardedCompletionIndex.from_shards(shards)
    with pytest.raises(NotImplementedError, match="packed"):
        dist.stack_shards(shards)


def test_session_and_service_errors():
    idx = rt.ShardedCompletionIndex(*PAPER, [], n_shards=2, kind="et",
                                    device="cpu")
    assert issubclass(rt.UnsupportedOnShardedIndex, NotImplementedError)
    for call in (idx.session, idx.open_session):
        with pytest.raises(rt.UnsupportedOnShardedIndex,
                           match="locus frontier"):
            call(k=2)
    svc = rt.CompletionService(idx)
    with pytest.raises(rt.UnsupportedOnShardedIndex,
                       match="local CompletionIndex") as err:
        svc.open_session(k=2)
    assert "complete()" in str(err.value)
    with pytest.raises(rt.UnsupportedOnShardedIndex, match="per-shard"):
        svc.compact()
    assert svc.complete(["andy", "w"], k=2) == [
        [], [(4, "william smith")]]
