"""Saving and loading: the format-4 container crosses between the two
packages both ways with the same answers.

The port builds and saves, ``repro``'s ``CompletionIndex.load`` answers
as ``repro``'s own build; ``repro`` saves, the port's
``CompletionIndex.load(device="cpu")`` answers the same — dense, packed,
cached, at an edit budget and multiterm.  One build per layout gives the
same arrays (names, dtypes, values) and the same metadata in both
packages' containers, apart from the substrate (each package writes one
its own loader resolves) and the build's wall time.  Answers are
(score, string) lists, compared exactly.
"""

import dataclasses
import json
from functools import lru_cache

import numpy as np
import pytest

import repro_torch as rt
from repro.api import CompletionIndex as JaxIndex
from repro.api import IndexSpec as JaxSpec
from repro.api import build_index as jax_build
from repro.core import make_rules as jax_rules
from repro.data.strings import make_usps, make_workload
from repro_torch.api.build import derived_stats
from repro_torch.core import trie_build as tb
from repro_torch.core.trie_build import make_rules
from torch_fast_jit import fast_jax_jit  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

K = 10
MT = ([b"the new york times", b"new york", b"san francisco giants",
       b"the giants", b"new jersey", b"times square"],
      [60, 50, 40, 30, 20, 10], [])
MT_QUERIES = [b"the t", b"the york t", b"san g", b"t", b"new y", b"x"]
MT_SPEC = dict(frontier=32, gens=32, expand=4, max_steps=128)

# (id, corpus, kind, spec options, whether repro's load of the port's
# container also answers the workload; every case holds its device arrays
# and config to repro's own build's)
CASES = [
    ("et", "usps", "et", {}, True),
    ("et-packed", "usps", "et", dict(compression="packed"), False),
    ("et-packed-cache16", "usps", "et",
     dict(compression="packed", cache_k=16), True),
    ("tt-E1", "usps", "tt", dict(edit_budget=1), False),
    ("plain-cache16", "usps", "plain", dict(cache_k=16), False),
    ("multiterm-packed", "mt", "multiterm",
     dict(MT_SPEC, compression="packed"), True),
]


@lru_cache(maxsize=None)
def _corpus(name):
    if name == "mt":
        return MT[0], MT[1], MT[2], MT_QUERIES
    ds = make_usps(400, seed=0)
    # eight bytes at most: one query-length bucket
    return (ds.strings, ds.scores, ds.rules,
            [q[:8] for q in make_workload(ds, 14, seed=1)] + ["", "zzz"])


def _pair(corpus, kind, **kw):
    strings, scores, rules, _ = _corpus(corpus)
    rules = rules if kind != "plain" else []
    j = jax_build(strings, scores, jax_rules(rules),
                  JaxSpec(kind=kind, substrate="jnp", **kw))
    p = rt.build_index(strings, scores, make_rules(rules),
                       rt.IndexSpec(kind=kind, **kw), device="cpu")
    return j, p


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_containers_cross_between_packages(tmp_path, case):
    _, corpus, kind, kw, answer = case
    j, p = _pair(corpus, kind, **kw)
    queries = _corpus(corpus)[3]
    want = j.complete(queries, k=K)
    assert p.complete(queries, k=K) == want
    p.save(str(tmp_path / "port.npz"))
    j.save(str(tmp_path / "repro.npz"))
    from_port = JaxIndex.load(str(tmp_path / "port.npz"))
    assert from_port.substrate == "jnp" and from_port.cfg == j.cfg
    for name in j.device._fields:
        a, b = getattr(j.device, name), getattr(from_port.device, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=name)
    if answer:
        assert from_port.complete(queries, k=K) == want
    from_repro = rt.CompletionIndex.load(str(tmp_path / "repro.npz"),
                                         device="cpu")
    assert from_repro.substrate == "torch"
    assert from_repro.complete(queries, k=K) == want
    for idx in (from_port, from_repro):
        assert idx.compression == j.compression
        assert idx.spec.replace(substrate="auto") == \
            type(idx.spec)(**j.spec.replace(substrate="auto").to_dict())


def _container(path):
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files if k != "__meta__"}
        meta = json.loads(z["__meta__"].tobytes().decode())
    return arrays, meta


#: the metadata entries the packages write apart: the substrate (each
#: writes one its own loader resolves) and the build's wall time
APART = {("spec", "substrate"), ("cfg", "substrate"),
         ("stats", "build_seconds")}


@pytest.mark.parametrize("kw", [{}, dict(compression="packed", cache_k=16)],
                         ids=["dense", "packed-cache16"])
def test_one_build_gives_the_same_container(tmp_path, kw):
    j, p = _pair("usps", "ht", **kw)
    j.save(str(tmp_path / "repro.npz"))
    p.save(str(tmp_path / "port.npz"))
    ja, jm = _container(str(tmp_path / "repro.npz"))
    pa, pm = _container(str(tmp_path / "port.npz"))
    assert sorted(pa) == sorted(ja)
    for name in ja:
        assert pa[name].dtype == ja[name].dtype, name
        np.testing.assert_array_equal(pa[name], ja[name], err_msg=name)
    assert sorted(pm) == sorted(jm)
    for key in jm:
        if not isinstance(jm[key], dict):
            assert pm[key] == jm[key], key
            continue
        assert sorted(pm[key]) == sorted(jm[key]), key
        for sub in jm[key]:
            if (key, sub) not in APART:
                assert pm[key][sub] == jm[key][sub], (key, sub)
    assert pm["spec"]["substrate"] == "auto"
    assert jm["spec"]["substrate"] == "jnp"


def test_epoch_survives_save_and_load(tmp_path):
    j, p = _pair("usps", "et")
    for idx in (j, p):
        idx.reconfigure(edit_budget=1)
        idx.reconfigure(frontier=64)
    assert p.epoch == j.epoch == 2
    p.save(str(tmp_path / "port.npz"))
    j.save(str(tmp_path / "repro.npz"))
    assert JaxIndex.load(str(tmp_path / "port.npz")).epoch == 2
    for path in ("port.npz", "repro.npz"):
        q = rt.CompletionIndex.load(str(tmp_path / path), device="cpu")
        assert q.epoch == 2
        assert (q.cfg.edit_budget, q.cfg.frontier) == (1, 64)
        assert q.session(k=3)._epoch == 2


def test_build_from_spec_and_compression_match_repro():
    strings, scores, rules, queries = _corpus("usps")
    kw = dict(alpha=0.3, cache_k=4, frontier=48, compression="packed")
    j = JaxIndex.build(strings, scores, jax_rules(rules), "et", **kw)
    p = rt.CompletionIndex.build(strings, scores, make_rules(rules), "et",
                                 device="cpu", **kw)
    assert p.compression == j.compression == "packed"
    assert p.spec.to_dict() == dict(j.spec.to_dict(), substrate="auto")
    assert p.complete(queries, k=3) == j.complete(queries, k=3)
    spec = rt.IndexSpec(kind="tt", cache_k=8)
    q = rt.CompletionIndex.from_spec(strings, scores, make_rules(rules),
                                     spec, device="cpu")
    assert q.spec == spec and q.compression == "none"
    assert q.stats.bytes_total == JaxIndex.from_spec(
        strings, scores, jax_rules(rules),
        JaxSpec(kind="tt", cache_k=8)).stats.bytes_total


@pytest.mark.parametrize("kw", [dict(cache_k=16),
                                dict(compression="packed", cache_k=16)],
                         ids=["cache16", "packed-cache16"])
def test_derived_index_saves_with_derived_stats(tmp_path, kw):
    """An index made by from_parts from another build's host trie (a
    cache or the packed layout added, as the card's smoke derives them)
    saves only with stats, and ``derived_stats`` gives the bytes a build
    in that layout reports."""
    strings, scores, rules, queries = _corpus("usps")
    base = rt.build_index(strings, scores, make_rules(rules), kind="et",
                          device="cpu")
    want = rt.build_index(strings, scores, make_rules(rules), kind="et",
                          device="cpu", **kw)
    trie = dataclasses.replace(base.trie)
    if kw.get("cache_k"):
        tb.build_topk_cache(trie, kw["cache_k"])
    widths = (tb.pack_compressed(trie) if kw.get("compression") == "packed"
              else {})
    assert tuple(sorted(widths.items())) == want.cfg.table_widths
    cfg = want.cfg
    bare = rt.CompletionIndex.from_parts(
        trie, base.rule_trie, base.rules, base.strings, base.scores, cfg,
        device="cpu", spec=want.spec)
    with pytest.raises(ValueError, match="BuildStats"):
        bare.save(str(tmp_path / "x.npz"))
    stats = derived_stats(base.stats, trie, base.rule_trie)
    for f in want.stats.__dataclass_fields__:
        if f != "build_seconds":
            assert getattr(stats, f) == getattr(want.stats, f), f
    idx = rt.CompletionIndex.from_parts(
        trie, base.rule_trie, base.rules, base.strings, base.scores, cfg,
        device="cpu", spec=want.spec, stats=stats)
    idx.save(str(tmp_path / "derived.npz"))
    back = rt.CompletionIndex.load(str(tmp_path / "derived.npz"),
                                   device="cpu")
    assert back.complete(queries, k=K) == want.complete(queries, k=K)
