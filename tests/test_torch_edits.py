"""Bounded-edit completion (``edit_budget`` 1 and 2) in the port against
the JAX package.

The same corpora and queries go through ``repro`` (``substrate="jnp"``),
``repro.core.oracle.OracleIndex(edit_budget=)`` and the port on the CPU:
the scores, string ids and
``exact`` flags of ``complete_batch`` and the answers of ``complete``,
the widened retry included, against ``repro``; the answers of every
kind, layout and cache depth against the oracle; ``reconfigure``; and
containers saved by ``repro`` with an edit budget.  Every output is an
integer, so equality is exact.  The CUDA kernel is held against these
plain versions on the card by ``chip_smoke.py``.  The locus DP's loci and
overflow counts against ``repro`` are in ``test_torch_edit_locus.py``.

JAX compiles a reference per engine config (seconds each at E = 2), so
the JAX comparisons are few and the oracle carries the wide matrix.  Each
JAX reference is compiled once, with XLA's cheapest optimization
(``tests/torch_fast_jit.py``; the answers are integers, equal at any
level), and each corpus index is built once a module.
"""

from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch as rt
from repro.core import engine as jeng
from repro.core.oracle import OracleIndex
from repro_torch.core.alphabet import pad_queries
from repro_torch.core.engine import locus
from repro_torch.core.engine import packed as pk
from repro_torch.core.engine.substrate import complete_batch, get_substrate
from repro_torch.kernels import locus_dp, trie_walk
from torch_edit_corpora import built_once_a_module  # noqa: F401
from torch_edit_corpora import (KINDS, built, corpus, jax_index, port_index,
                                rules_of)
from torch_fast_jit import fast_jax_jit, fast_jit  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

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

_complete_ref = fast_jit(jeng.complete_batch, static_argnums=(1, 4, 5))


def _assert_matches_oracle(data, kind, e, queries, rows, k):
    """Scores in order, strings as sets per score (the oracle ranks equal
    scores by string, the engine by emission order)."""
    strings, scores, rules = data
    oracle = OracleIndex(strings, scores, rules_of(rules, kind), edit_budget=e)
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


# -- complete against repro -----------------------------------------------------


@pytest.mark.parametrize("kind,e,compression,cache_k", [
    ("et", 1, "none", 0), ("ht", 2, "packed", 16)])
def test_edit_complete_batch_matches_repro(kind, e, compression, cache_k):
    """Scores, string ids and ``exact`` flags of one engine pass equal
    ``repro``'s (jnp)."""
    _, queries = corpus("usps")
    kw = dict(compression=compression, cache_k=cache_k)
    (jcfg, j), (cfg, p) = (built("jax", "usps", kind, e, **kw),
                           built("port", "usps", kind, e, **kw))
    qa, la = pad_queries(queries, 16)
    want = _complete_ref(j.device, jcfg, jnp.asarray(qa), jnp.asarray(la),
                         5, jeng.get_substrate("jnp"))
    got = complete_batch(p.tensors, cfg, torch.from_numpy(qa),
                         torch.from_numpy(la), 5)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert not got[2].all() or e == 1    # E = 2 overflows: retry needed


def test_edit_complete_with_retry_matches_repro():
    """``complete`` at E = 2, where the first pass is inexact and the
    widened retry runs, answers as ``repro`` does."""
    data, queries = corpus("usps")
    j = jax_index(data, "plain", edit_budget=2)
    p = port_index(data, "plain", edit_budget=2)
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
        idx = port_index(data, kind, edit_budget=e,
                         compression=compression, cache_k=cache_k, **SPEC)
        rows = idx.complete(queries, k=3)
        _assert_matches_oracle(data, kind, e, queries, rows, 3)
        # the cuda substrate's routing, answered by the plain versions
        assert idx.reconfigure(substrate="cuda").complete(queries, k=3) \
            == rows


@pytest.mark.parametrize("compression", ["none", "packed"])
@pytest.mark.parametrize("kind", ["tt", "et"])
def test_edit_corpus_complete_matches_oracle(kind, compression):
    data, queries = corpus("usps")
    idx = port_index(data, kind, edit_budget=1, compression=compression)
    _assert_matches_oracle(data, kind, 1, queries,
                           idx.complete(queries, k=4), 4)


# -- reconfigure, containers, the empty prefix ------------------------------------


@pytest.mark.parametrize("compression", ["none", "packed"])
@pytest.mark.parametrize("kind", KINDS)
def test_reconfigure_edit_budget_equals_build(kind, compression):
    """``reconfigure(edit_budget=)`` on a built index, without a rebuild,
    answers as a build with that budget, and back at 0 as before."""
    data = (STRINGS, SCORES, RULES)
    idx = port_index(data, kind, compression=compression, **SPEC)
    exact_rows = idx.complete(EDIT_QUERIES, k=3)
    trie = idx.tensors
    for e in (1, 2):
        fresh = port_index(data, kind, edit_budget=e,
                           compression=compression, **SPEC)
        assert idx.reconfigure(edit_budget=e).complete(EDIT_QUERIES, k=3) \
            == fresh.complete(EDIT_QUERIES, k=3)
        assert idx.cfg.edit_budget == e and idx.spec.edit_budget == e
        assert idx.tensors is trie
    assert idx.reconfigure(edit_budget=0).complete(EDIT_QUERIES, k=3) \
        == exact_rows


def test_edit_budget_out_of_range_raises():
    with pytest.raises(ValueError, match="edit_budget"):
        port_index(FIG1, "et", edit_budget=3)
    idx = port_index(FIG1, "et")
    with pytest.raises(ValueError, match="edit_budget"):
        idx.reconfigure(edit_budget=-1)


@pytest.mark.parametrize("compression", ["none", "packed"])
@pytest.mark.parametrize("kind", ["plain", "ht"])
def test_load_repro_edit_container(tmp_path, kind, compression):
    """A container saved by ``repro`` with ``edit_budget=1`` loads with
    the budget and the JAX package's ``branch_width``, and answers as the
    port's own build."""
    data, queries = corpus("usps")
    j = jax_index(data, kind, edit_budget=1, compression=compression)
    p = port_index(data, kind, edit_budget=1, compression=compression)
    path = str(tmp_path / "edits.npz")
    j.save(path)
    q = rt.load_index(path, device="cpu")
    assert q.cfg.edit_budget == 1 and q.spec.edit_budget == 1
    assert q.cfg.branch_width == j.cfg.branch_width == p.cfg.branch_width
    assert q.complete(queries, k=4) == p.complete(queries, k=4)


@pytest.mark.parametrize("compression", ["none", "packed"])
def test_from_parts_keeps_branch_width(compression):
    data, _ = corpus("usps")
    j = jax_index(data, "ht", compression=compression)
    q = rt.CompletionIndex.from_parts(j.trie, j.rule_trie, j.rules,
                                      j.strings, j.scores, j.cfg,
                                      device="cpu")
    assert q.cfg.branch_width == j.cfg.branch_width > 1


@pytest.mark.parametrize("compression", ["none", "packed"])
@pytest.mark.parametrize("e", [1, 2])
def test_empty_prefix_edit_budget_stays_whole_dict(e, compression):
    """At the empty prefix every string matches exactly; an edit budget
    must not change the answer (deletes only widen the reach)."""
    idx = port_index((STRINGS, SCORES, []), "plain", edit_budget=e,
                     compression=compression, **SPEC)
    assert idx.complete([b""], k=3)[0] == [(60, "andy pavlo"),
                                           (50, "android"), (40, "andrew")]


def test_cuda_substrate_routes_edit_walks_to_locus_dp():
    """A plain-kind dense index walks by the prefix kernel at E = 0 and by
    the locus DP at E > 0 (the single-locus invariant no longer holds);
    on CPU tensors the wrappers answer with their plain versions."""
    idx = port_index((STRINGS, SCORES, []), "plain", **SPEC)
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
    idx = port_index(FIG1, "et")
    n = int(idx.tensors.syn_mask.shape[0])
    locus.check_state_range(idx.tensors, replace(idx.cfg, edit_budget=2))
    big = idx.tensors._replace(
        syn_mask=torch.zeros(1, dtype=torch.bool).expand(2**30))
    assert n < 2**30
    with pytest.raises(ValueError, match="int32"):
        locus.check_state_range(big, replace(idx.cfg, edit_budget=1))
