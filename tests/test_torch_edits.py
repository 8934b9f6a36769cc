"""Bounded-edit completion (``edit_budget`` 1 and 2) in the port against
the JAX package.

The same corpora and queries go through ``repro`` (``substrate="jnp"``),
``repro.core.oracle.OracleIndex(edit_budget=)`` and the port on the CPU:
the loci and overflow counts of the plain locus DP (dense and packed)
against ``repro.kernels.ref.locus_walk_ref``; the scores, string ids and
``exact`` flags of ``complete_batch`` and the answers of ``complete``,
the widened retry included, against ``repro``; the answers of every
kind, layout and cache depth against the oracle; ``reconfigure``; and
containers saved by ``repro`` with an edit budget.  Every output is an
integer, so equality is exact.  The CUDA kernel is held against these
plain versions on the card by ``chip_smoke.py``.

JAX compiles a reference per engine config (seconds each at E = 2), so
the JAX comparisons are few and the oracle carries the wide matrix.
"""

from dataclasses import replace
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch as rt
from repro.api import IndexSpec as JaxSpec
from repro.api import build_index as jax_build
from repro.core import engine as jeng
from repro.core import make_rules
from repro.core.oracle import OracleIndex
from repro.data.strings import make_dblp, make_usps, make_workload
from repro.kernels import ref as jref
from repro_torch.core.alphabet import pad_queries
from repro_torch.core.engine import locus
from repro_torch.core.engine import packed as pk
from repro_torch.core.engine.substrate import complete_batch, get_substrate
from repro_torch.kernels import locus_dp, trie_walk
from torch_threads import one_torch_thread  # noqa: F401

KINDS = ["plain", "tt", "et", "ht"]
# the cases of tests/test_modes.py: typos of every kind around a rule
STRINGS = [b"andy pavlo", b"android", b"andrew", b"banana", b"sand",
           b"andyp"]
SCORES = [60, 50, 40, 30, 20, 10]
RULES = [("andy", "andrew"), ("ny", "new york")]
EDIT_QUERIES = [b"andy", b"andt", b"xndy", b"ady", b"anddy", b"ba", b"ny",
                b"sund", b""]
SPEC = dict(frontier=16, gens=16, expand=2, max_steps=64)
# the paper's Figure 1 strings, with typos
FIG1 = (["andrew pavlo", "andrew parker", "andrew packard", "william smith",
         "bill of rights"], [50, 40, 30, 20, 10],
        [("andy", "andrew"), ("bill", "william")])
FIG1_QUERIES = ["andy pa", "andt pa", "andrew pa", "bil", "bll of", "wiliam",
                "a", "", "xyz", "andy pavloz"]

_FAST = {"xla_backend_optimization_level": 0}
_locus_ref = jax.jit(jref.locus_walk_ref, static_argnums=1,
                     compiler_options=_FAST)


def _rules(rules, kind):
    return make_rules(rules) if kind != "plain" else []


@lru_cache(maxsize=2)
def _corpus(name):
    """A 2,000-string cut of USPS or DBLP and 13 of its queries."""
    ds = make_usps(2000, seed=4) if name == "usps" else make_dblp(2000, seed=2)
    queries = make_workload(ds, 11, seed=6) + ["", "qqq"]
    return (ds.strings, ds.scores, ds.rules), queries


def _port(data, kind, **kw):
    strings, scores, rules = data
    return rt.build_index(strings, scores, _rules(rules, kind),
                          rt.IndexSpec(kind=kind, **kw), device="cpu")


def _jax(data, kind, **kw):
    strings, scores, rules = data
    return jax_build(strings, scores, _rules(rules, kind),
                     JaxSpec(kind=kind, substrate="jnp", **kw))


def _assert_matches_oracle(data, kind, e, queries, rows, k):
    """Scores in order, strings as sets per score (the oracle ranks equal
    scores by string, the engine by emission order)."""
    strings, scores, rules = data
    oracle = OracleIndex(strings, scores, _rules(rules, kind), edit_budget=e)
    for q, row in zip(queries, rows):
        want = oracle.complete(q, k)
        assert [s for s, _ in row] == [s for s, _ in want], (q, e)
        matches = {x.decode() for x in oracle.matches(q)}
        assert {x for _, x in row} <= matches, (q, e)
        for score in {s for s, _ in want}:
            if sum(1 for s, _ in want if s == score) == \
                    sum(1 for s, _ in oracle.complete(q, 10**6)
                        if s == score):
                assert {x for s, x in row if s == score} == \
                    {x.decode() for s, x in want if s == score}, (q, e)


# -- the locus DP: loci and overflow against repro ----------------------------

# DBLP's hybrid build runs its rule knapsack for ~30 s: ht takes USPS
CORPUS_OF = {"plain": "usps", "tt": "dblp", "et": "usps", "ht": "usps"}


@pytest.mark.parametrize("e", [1, 2])
@pytest.mark.parametrize("kind", KINDS)
def test_edit_locus_matches_repro(kind, e):
    """The plain locus DP at E = e, dense and packed, equals
    ``repro.kernels.ref.locus_walk_ref`` on ``repro``'s dense index: loci
    (node ids are shared by the layouts) and overflow counts, which the
    2,000-string cut makes nonzero at E = 2."""
    data, queries = _corpus(CORPUS_OF[kind])
    j = _jax(data, kind, edit_budget=e)
    qa, la = pad_queries([q[:8] for q in queries], 8)
    want = _locus_ref(j.device, j.cfg, jnp.asarray(qa), jnp.asarray(la))
    qt, lt = torch.from_numpy(qa), torch.from_numpy(la)
    for compression in ("none", "packed"):
        p = _port(data, kind, edit_budget=e, compression=compression)
        assert p.cfg.branch_width == j.cfg.branch_width
        got = locus_dp.locus_dp_walk(p.tensors, p.cfg, qt, lt)
        for a, b in zip(want, got):
            np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                          err_msg=compression)
    if e == 2:
        assert (got[1] > 0).any()


def test_edit_transitions_mirror_repro():
    """The state packing and the dense and packed child windows equal the
    JAX package's on every node."""
    from repro.core.engine import locus as jlocus

    data, _ = _corpus("usps")
    j = _jax(data, "et")
    p = _port(data, "et")
    pp = _port(data, "et", compression="packed")
    jp = _jax(data, "et", compression="packed")
    n = int(p.tensors.syn_mask.shape[0])
    nodes = np.concatenate([[-1], np.arange(n)]).astype(np.int32)
    nt = torch.from_numpy(nodes)
    for jt, pt, jcfg in ((j.device, p.tensors, j.cfg),
                         (jp.device, pp.tensors, jp.cfg)):
        want = jlocus.dict_child_window(jt, jcfg, jnp.asarray(nodes))
        got = locus.dict_child_window(pt, p.cfg, nt)
        for a, b in zip(want, got):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    for e in (0, 1, 2):
        d = torch.from_numpy((nodes % (e + 1)).astype(np.int32))
        st = locus.encode_states(nt, d, e)
        np.testing.assert_array_equal(
            np.asarray(jlocus.encode_states(jnp.asarray(nodes),
                                            jnp.asarray(d.numpy()), e)),
            st.numpy())
        back = locus.decode_states(st, e)
        assert torch.equal(back[0], nt)
        assert torch.equal(back[1], torch.where(nt < 0, 0, d))


# -- complete against repro -----------------------------------------------------


@pytest.mark.parametrize("kind,e,compression,cache_k", [
    ("et", 1, "none", 0), ("ht", 2, "packed", 16)])
def test_edit_complete_batch_matches_repro(kind, e, compression, cache_k):
    """Scores, string ids and ``exact`` flags of one engine pass equal
    ``repro``'s (jnp)."""
    data, queries = _corpus("usps")
    kw = dict(edit_budget=e, compression=compression, cache_k=cache_k)
    j, p = _jax(data, kind, **kw), _port(data, kind, **kw)
    qa, la = pad_queries(queries, 16)
    want = jeng.complete_batch(j.device, j.cfg, jnp.asarray(qa),
                               jnp.asarray(la), 5,
                               jeng.get_substrate("jnp"))
    got = complete_batch(p.tensors, p.cfg, torch.from_numpy(qa),
                         torch.from_numpy(la), 5)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert not got[2].all() or e == 1    # E = 2 overflows: retry needed


def test_edit_complete_with_retry_matches_repro():
    """``complete`` at E = 2, where the first pass is inexact and the
    widened retry runs, answers as ``repro`` does."""
    data, queries = _corpus("usps")
    j = _jax(data, "plain", edit_budget=2)
    p = _port(data, "plain", edit_budget=2)
    qa, la = pad_queries(queries, 16)
    _, _, exact = complete_batch(p.tensors, p.cfg, torch.from_numpy(qa),
                                 torch.from_numpy(la), 5)
    assert not exact.all()
    rows = p.complete(queries, k=5)
    assert rows == j.complete(queries, k=5)
    _assert_matches_oracle(data, "plain", 2, queries, rows, 5)


# -- complete against the oracle --------------------------------------------------


@pytest.mark.parametrize("cache_k", [0, 16])
@pytest.mark.parametrize("compression", ["none", "packed"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("e", [1, 2])
def test_edit_complete_matches_oracle(e, kind, compression, cache_k):
    """Every kind, layout and cache depth at E = e equals the edit-aware
    oracle on the mode cases and the Figure 1 strings."""
    for data, queries in (((STRINGS, SCORES, RULES), EDIT_QUERIES),
                          (FIG1, FIG1_QUERIES)):
        idx = _port(data, kind, edit_budget=e, compression=compression,
                    cache_k=cache_k, **SPEC)
        rows = idx.complete(queries, k=3)
        _assert_matches_oracle(data, kind, e, queries, rows, 3)
        # the cuda substrate's routing, answered by the plain versions
        assert idx.reconfigure(substrate="cuda").complete(queries, k=3) \
            == rows


@pytest.mark.parametrize("compression", ["none", "packed"])
@pytest.mark.parametrize("kind", ["tt", "et"])
def test_edit_corpus_complete_matches_oracle(kind, compression):
    data, queries = _corpus("usps")
    idx = _port(data, kind, edit_budget=1, compression=compression)
    _assert_matches_oracle(data, kind, 1, queries,
                           idx.complete(queries, k=4), 4)


# -- reconfigure, containers, the empty prefix ------------------------------------


@pytest.mark.parametrize("compression", ["none", "packed"])
@pytest.mark.parametrize("kind", KINDS)
def test_reconfigure_edit_budget_equals_build(kind, compression):
    """``reconfigure(edit_budget=)`` on a built index, without a rebuild,
    answers as a build with that budget, and back at 0 as before."""
    data = (STRINGS, SCORES, RULES)
    idx = _port(data, kind, compression=compression, **SPEC)
    exact_rows = idx.complete(EDIT_QUERIES, k=3)
    trie = idx.tensors
    for e in (1, 2):
        built = _port(data, kind, edit_budget=e, compression=compression,
                      **SPEC)
        assert idx.reconfigure(edit_budget=e).complete(EDIT_QUERIES, k=3) \
            == built.complete(EDIT_QUERIES, k=3)
        assert idx.cfg.edit_budget == e and idx.spec.edit_budget == e
        assert idx.tensors is trie
    assert idx.reconfigure(edit_budget=0).complete(EDIT_QUERIES, k=3) \
        == exact_rows


def test_edit_budget_out_of_range_raises():
    with pytest.raises(ValueError, match="edit_budget"):
        _port(FIG1, "et", edit_budget=3)
    idx = _port(FIG1, "et")
    with pytest.raises(ValueError, match="edit_budget"):
        idx.reconfigure(edit_budget=-1)


@pytest.mark.parametrize("compression", ["none", "packed"])
@pytest.mark.parametrize("kind", ["plain", "ht"])
def test_load_repro_edit_container(tmp_path, kind, compression):
    """A container saved by ``repro`` with ``edit_budget=1`` loads with
    the budget and the JAX package's ``branch_width``, and answers as the
    port's own build."""
    data, queries = _corpus("usps")
    j = _jax(data, kind, edit_budget=1, compression=compression)
    p = _port(data, kind, edit_budget=1, compression=compression)
    path = str(tmp_path / "edits.npz")
    j.save(path)
    q = rt.load_index(path, device="cpu")
    assert q.cfg.edit_budget == 1 and q.spec.edit_budget == 1
    assert q.cfg.branch_width == j.cfg.branch_width == p.cfg.branch_width
    assert q.complete(queries, k=4) == p.complete(queries, k=4)


@pytest.mark.parametrize("compression", ["none", "packed"])
def test_from_parts_keeps_branch_width(compression):
    data, _ = _corpus("usps")
    j = _jax(data, "ht", compression=compression)
    q = rt.CompletionIndex.from_parts(j.trie, j.rule_trie, j.rules,
                                      j.strings, j.scores, j.cfg,
                                      device="cpu")
    assert q.cfg.branch_width == j.cfg.branch_width > 1


@pytest.mark.parametrize("compression", ["none", "packed"])
@pytest.mark.parametrize("e", [1, 2])
def test_empty_prefix_edit_budget_stays_whole_dict(e, compression):
    """At the empty prefix every string matches exactly; an edit budget
    must not change the answer (deletes only widen the reach)."""
    idx = _port((STRINGS, SCORES, []), "plain", edit_budget=e,
                compression=compression, **SPEC)
    assert idx.complete([b""], k=3)[0] == [(60, "andy pavlo"),
                                           (50, "android"), (40, "andrew")]


def test_cuda_substrate_routes_edit_walks_to_locus_dp():
    """A plain-kind dense index walks by the prefix kernel at E = 0 and by
    the locus DP at E > 0 (the single-locus invariant no longer holds);
    on CPU tensors the wrappers answer with their plain versions."""
    idx = _port((STRINGS, SCORES, []), "plain", **SPEC)
    assert not pk.is_packed(idx.tensors)
    qa, la = pad_queries(EDIT_QUERIES, 8)
    qt, lt = torch.from_numpy(qa), torch.from_numpy(la)
    cuda = get_substrate("cuda")
    for e, walk in ((0, "prefix"), (1, "locus"), (2, "locus")):
        cfg = replace(idx.cfg, edit_budget=e)
        before = (trie_walk.plain_calls, locus.calls)
        got = cuda.walk_batch(idx.tensors, cfg, qt, lt)
        after = (trie_walk.plain_calls, locus.calls)
        assert (after[0] - before[0], after[1] - before[1]) == \
            ((1, 0) if walk == "prefix" else (0, 1))
        want = get_substrate("torch").walk_batch(idx.tensors, cfg, qt, lt)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# -- the kernel's launch plan -----------------------------------------------------


def test_launch_shape_sizes_the_largest_merge():
    """The candidate rows hold the largest merge of a step: the literal
    step's F·(4+BW) at E > 0, the delete round's F·(1+BW), the
    teleports' F·(1+Tw).  The block has 4F threads (whole warps, at most
    512), one per slot of the widest common merge, whatever the candidate
    capacity."""
    from repro_torch.core.engine.structs import EngineConfig

    cfg = EngineConfig(frontier=32, branch_width=37, teleports=2,
                       tele_width=3)
    assert locus_dp.launch_shape(cfg, 32).cand == 128      # 3F (E = 0)
    widths = locus_dp.merge_widths(replace(cfg, edit_budget=1))
    assert widths == {"literal": 32 * 41, "rule": 64, "delete": 32 * 38,
                      "teleport": 128}
    ls = locus_dp.launch_shape(replace(cfg, edit_budget=2), 32)
    assert ls.cand == 2048 and ls.threads == 128
    assert (ls.buf_in_ws, ls.cand_in_ws, ls.ws_stride) == (0, 0, 0)
    # whole warps (the merges ballot and shuffle), 512 at most
    assert [locus_dp.launch_shape(replace(cfg, frontier=f), 32).threads
            for f in (2, 8, 100, 256)] == [32, 32, 512, 512]


@pytest.mark.parametrize("F,L,where", [
    (256, 32, (0, 0)), (256, 64, (0, 1)), (256, 512, (1, 1))])
def test_launch_shape_moves_rows_to_a_workspace(F, L, where):
    """The widened retry's widths at E > 0 (F = 256, BW = 37: 16,384
    candidates) fit shared memory at L = 32 and take a workspace slice
    past it, for the candidate rows and then for the frontier."""
    from repro_torch.core.engine.structs import EngineConfig

    cfg = EngineConfig(frontier=F, branch_width=37, edit_budget=1)
    ls = locus_dp.launch_shape(cfg, L)
    assert ls.cand == 16384
    assert (ls.buf_in_ws, ls.cand_in_ws) == where
    assert ls.shared <= 232_448
    assert ls.ws_stride == 3 * 16384 * where[1] + (L + 1) * F * where[0]


@pytest.mark.parametrize("W,F,plan", [
    (48, 32, (64, 32, 2496)), (192, 64, (256, 128, 7488)),
    (768, 128, (1024, 512, 27456)), (3072, 256, (4096, 1024, 107328))])
def test_beam_launch_shape_at_the_retry_widths(W, F, plan):
    """The beam's block at the default widths and each retry round's (W
    x4 a round): sort keys for the first step's W + P, one thread per two
    keys (one warp at W = 48), and the shared bytes of the keys, both
    pools, both heaps and a later step's 2P changed entries and P
    leaves."""
    from repro_torch.core.engine.structs import EngineConfig
    from repro_torch.kernels import beam_topk

    cfg = EngineConfig(frontier=F, gens=W)
    assert (cfg.expand, beam_topk.launch_shape(cfg, 10)) == (8, plan)


def test_beam_launch_shape_raises_past_shared_memory():
    from repro_torch.core.engine.structs import EngineConfig
    from repro_torch.kernels import beam_topk

    with pytest.raises(ValueError, match="shared memory"):
        beam_topk.launch_shape(EngineConfig(gens=8192), 10)


def test_launch_shape_raises_past_int32_offsets():
    from repro_torch.core.engine.structs import EngineConfig

    cfg = EngineConfig(frontier=2**22, branch_width=200, edit_budget=2)
    with pytest.raises(ValueError, match="workspace"):
        locus_dp.launch_shape(cfg, 8)


def test_state_range_is_checked():
    idx = _port(FIG1, "et")
    n = int(idx.tensors.syn_mask.shape[0])
    locus.check_state_range(idx.tensors, replace(idx.cfg, edit_budget=2))
    big = idx.tensors._replace(
        syn_mask=torch.zeros(1, dtype=torch.bool).expand(2**30))
    assert n < 2**30
    with pytest.raises(ValueError, match="int32"):
        locus.check_state_range(big, replace(idx.cfg, edit_budget=1))
