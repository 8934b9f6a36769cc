"""The sharded index in local mode, continued from
``tests/test_torch_sharded.py`` (whose helpers it uses): the rule-bearing
kinds' answers at 3 shards (tt, ht) against ``repro``'s local mode
(``substrate="jnp"``), the oracle and the unsharded index; ``repro``'s
absence of a widened retry, kept; the two faults of ``repro``'s sharded
mode that the port repairs (a multi-byte query padded by characters, the
``(1, '')`` answer of an empty shard); save and load crossing both ways;
and the targeted errors.  One file would take longer than a minute on one
worker: ``repro``'s sharded jit compiles each (batch, length, k, config)
shape in ~3-20 s here.
"""

import json

import pytest
import torch

import repro_torch as rt
from repro.core import distributed as jax_dist
from repro_torch.core import distributed as dist
from repro_torch.core.trie_build import make_rules
from test_torch_sharded import (CACHE_K, K_BIG, K_SMALL, _corpus, _jax,
                                _port, check_answers)
from torch_fast_jit import fast_jax_jit  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("n_shards,kind,cache_k,ks", [
    (3, "ht", CACHE_K, (K_SMALL,)),
    (3, "tt", 0, (K_BIG,)),
])
def test_answers_equal_repro_and_oracle(n_shards, kind, cache_k, ks):
    check_answers(n_shards, kind, cache_k, ks)


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
