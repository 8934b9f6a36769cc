"""The port's ``kernels.ops`` wrappers against ``repro.kernels.ops``.

The same index is built by both packages from the paper's example
(``repro`` on its ``"jnp"`` substrate), and each completion-path wrapper
runs on the same queries: ``repro``'s in interpret mode (its Pallas
kernels on the CPU, as its own tests run them), the port's through its
CPU branch (the kernel's plain version).  Covered: the dense and packed
layouts at edit budgets 0-2, ``streamed`` both ways, the three degenerate
shapes ``repro`` short-circuits (an empty dictionary's beam, ``k >= C``
in the select, ``k >= F*K`` in the cached merge) and the exceptions it
raises (``streamed`` without ``walk_tile``, the packed streamed beam,
``k > C``).  Every output is an integer or a flag, so equality is exact.
The CUDA kernels behind the wrappers are held against these plain
versions on the card by ``chip_smoke.py``.
"""

from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch as rt
from repro.api import IndexSpec as JaxSpec
from repro.api import build_index as jax_build
from repro.core import make_rules as jax_rules
from repro.core.alphabet import pad_queries
from repro.kernels import ops as jops
from repro_torch.core.trie_build import make_rules
from repro_torch.kernels import ops
from torch_fast_jit import fast_jax_jit  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

STRINGS = ["andrew pavlo", "andrew parker", "andrew packard",
           "william smith", "bill of rights"]
SCORES = [50, 40, 30, 20, 10]
RULES = [("andy", "andrew"), ("bill", "william")]
QUERIES = ["andy pa", "andrew pa", "bil", "bill of", "a", "", "xyz",
           "andy pavloz", "william smith", "w", "andrw"]
CACHE_K = 4
L = 16


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = _np(g), _np(w)
        assert g.shape == w.shape and g.dtype.kind == w.dtype.kind
        np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def queries():
    qs, ql = pad_queries(QUERIES, L)
    return (jnp.asarray(qs), jnp.asarray(ql), torch.from_numpy(qs),
            torch.from_numpy(ql))


@pytest.fixture(scope="module")
def pairs():
    """(repro index, port index) by (kind, compression, cache_k)."""
    out = {}
    for kind, compression, cache_k in (("et", "none", CACHE_K),
                                       ("et", "packed", CACHE_K),
                                       ("plain", "none", 0)):
        rules = RULES if kind != "plain" else []
        kw = dict(kind=kind, compression=compression, cache_k=cache_k)
        out[kind, compression] = (
            jax_build(STRINGS, SCORES, jax_rules(rules),
                      JaxSpec(substrate="jnp", **kw)),
            rt.build_index(STRINGS, SCORES, make_rules(rules),
                           rt.IndexSpec(**kw), device="cpu"))
    return out


@pytest.mark.parametrize("streamed", [False, True])
def test_trie_walk(pairs, queries, streamed):
    j, p = pairs["plain", "none"]
    jq, jl, pq, pl = queries
    tile = j.cfg.walk_tile if streamed else None
    d, t = j.device, p.tensors
    want = jops.trie_walk(d.first_child, d.edge_char, d.edge_child, jq, jl,
                          streamed=streamed, walk_tile=tile)
    got = ops.trie_walk(t.first_child, t.edge_char, t.edge_child, pq, pl,
                        streamed=streamed, walk_tile=tile)
    _same(got, want)


def test_trie_walk_streamed_needs_walk_tile(pairs, queries):
    j, p = pairs["plain", "none"]
    jq, jl, pq, pl = queries
    d, t = j.device, p.tensors
    with pytest.raises(ValueError):
        jops.trie_walk(d.first_child, d.edge_char, d.edge_child, jq, jl,
                       streamed=True)
    with pytest.raises(ValueError):
        ops.trie_walk(t.first_child, t.edge_char, t.edge_child, pq, pl,
                      streamed=True)


_WALKS = {}


def _walk(pairs, queries, compression, e, streamed):
    """Both packages' loci for one case, made once (the beam and the
    merge cases read them)."""
    key = (compression, e, streamed)
    if key not in _WALKS:
        j, p = pairs["et", compression]
        jq, jl, pq, pl = queries
        jcfg = replace(j.cfg, edit_budget=e)
        pcfg = replace(p.cfg, edit_budget=e)
        _WALKS[key] = (
            jops.locus_walk(j.device, jcfg, jq, jl, streamed=streamed),
            ops.locus_walk(p.tensors, pcfg, pq, pl, streamed=streamed),
            jcfg, pcfg)
    return _WALKS[key]


@pytest.mark.parametrize("compression,e,streamed", [
    ("none", 0, False), ("none", 0, True), ("none", 1, False),
    ("none", 2, False), ("packed", 0, False), ("packed", 0, True),
    ("packed", 1, False), ("packed", 2, False)])
def test_locus_walk(pairs, queries, compression, e, streamed):
    want, got, _, _ = _walk(pairs, queries, compression, e, streamed)
    _same(got, want)


@pytest.mark.parametrize("compression,e,streamed", [
    ("none", 0, False), ("none", 0, True), ("none", 1, False),
    ("none", 2, False), ("packed", 0, False), ("packed", 2, False)])
def test_beam_topk(pairs, queries, compression, e, streamed):
    j, p = pairs["et", compression]
    (jloci, _), (ploci, _), jcfg, pcfg = _walk(pairs, queries, compression,
                                               e, False)
    _same(ops.beam_topk(p.tensors, pcfg, ploci, 3, streamed=streamed),
          jops.beam_topk(j.device, jcfg, jloci, 3, streamed=streamed))


def test_beam_topk_packed_streamed_raises(pairs, queries):
    j, p = pairs["et", "packed"]
    (jloci, _), (ploci, _), jcfg, pcfg = _walk(pairs, queries, "packed", 0,
                                               False)
    with pytest.raises(ValueError):
        jops.beam_topk(j.device, jcfg, jloci, 3, streamed=True)
    with pytest.raises(ValueError):
        ops.beam_topk(p.tensors, pcfg, ploci, 3, streamed=True)


@pytest.mark.parametrize("streamed", [False, True])
def test_beam_topk_empty_dictionary(streamed):
    j = jax_build([], [], [], JaxSpec(kind="et", substrate="jnp"))
    p = rt.build_index([], [], [], rt.IndexSpec(kind="et"), device="cpu")
    loci = np.full((3, 32), -1, np.int32)
    _same(ops.beam_topk(p.tensors, p.cfg, torch.from_numpy(loci), 5,
                        streamed=streamed),
          jops.beam_topk(j.device, j.cfg, jnp.asarray(loci), 5,
                         streamed=streamed))


def _scores(B, C, seed):
    """Scores with many ties and a payload of distinct ids."""
    rng = np.random.default_rng(seed)
    s = rng.integers(-1, 6, (B, C)).astype(np.int32)
    p = rng.permutation(B * C).reshape(B, C).astype(np.int32)
    return s, p


@pytest.mark.parametrize("k", [1, 5, 12], ids=["k1", "k5", "k=C"])
def test_topk_select(k):
    s, p = _scores(9, 12, seed=k)
    _same(ops.topk_select(torch.from_numpy(s), torch.from_numpy(p), k),
          jops.topk_select(jnp.asarray(s), jnp.asarray(p), k))


def test_topk_select_k_past_c_raises():
    s, p = _scores(3, 4, seed=0)
    with pytest.raises(ValueError):
        jops.topk_select(jnp.asarray(s), jnp.asarray(p), 5)
    with pytest.raises(ValueError):
        ops.topk_select(torch.from_numpy(s), torch.from_numpy(p), 5)


@pytest.mark.parametrize("k,width", [(3, None), (CACHE_K, None), (6, 2),
                                     (8, 2), (11, 2)],
                         ids=["k3", "k=K", "k<F*K", "k=F*K", "k>F*K"])
def test_cached_topk_merge(pairs, queries, k, width):
    j, p = pairs["et", "none"]
    (jloci, _), (ploci, _), _, _ = _walk(pairs, queries, "none", 0, False)
    if width is not None:       # F = 2, so F*K = 8
        jloci, ploci = jloci[:, :width], ploci[:, :width].contiguous()
    _same(ops.cached_topk_merge(ploci, p.tensors.topk_score,
                                p.tensors.topk_sid, k),
          jops.cached_topk_merge(jloci, j.device.topk_score,
                                 j.device.topk_sid, k))


@pytest.mark.parametrize("k,width", [(3, None), (8, 2), (11, 2)],
                         ids=["k3", "k=F*K", "k>F*K"])
def test_cached_topk_merge_packed(pairs, queries, k, width):
    j, p = pairs["et", "packed"]
    (jloci, _), (ploci, _), _, _ = _walk(pairs, queries, "packed", 0, False)
    if width is not None:
        jloci, ploci = jloci[:, :width], ploci[:, :width].contiguous()
    _same(ops.cached_topk_merge_packed(p.tensors, ploci, k),
          jops.cached_topk_merge_packed(j.device, jloci, k))


@pytest.mark.parametrize("name", ["trie_walk", "locus_walk", "beam_topk",
                                  "topk_select", "cached_topk_merge",
                                  "cached_topk_merge_packed"])
def test_block_arguments_must_be_positive(pairs, queries, name):
    _, p = pairs["et", "packed"]
    _, _, pq, pl = queries
    t, cfg = p.tensors, p.cfg
    loci = torch.full((2, 4), -1, dtype=torch.int32)
    s = torch.zeros((2, 4), dtype=torch.int32)
    call = {
        "trie_walk": lambda b: ops.trie_walk(t.first_child, t.edge_char,
                                             t.edge_child, pq, pl, block_q=b),
        "locus_walk": lambda b: ops.locus_walk(t, cfg, pq, pl, block_q=b),
        "beam_topk": lambda b: ops.beam_topk(t, cfg, loci, 2, block_b=b),
        "topk_select": lambda b: ops.topk_select(s, s, 2, block_b=b),
        "cached_topk_merge": lambda b: ops.cached_topk_merge(
            loci, s, s, 2, block_b=b),
        "cached_topk_merge_packed": lambda b: ops.cached_topk_merge_packed(
            t, loci, 2, block_b=b)}[name]
    for bad in (0, -8):
        with pytest.raises(ValueError, match="positive"):
            call(bad)
    call(1)     # any positive block gives the same answer as the default
