"""Online mutations: the port's delta overlay, compaction and epoch
hot-swap against a from-scratch rebuild and against ``repro``.

A mutated index must answer bit-identically (scores, strings and tie
order) to the port's own ``build_index`` over its ``live_items()`` and to
``repro``'s index after the same mutations (``substrate="jnp"``), for
every kind, both layouts, with and without a cache and at edit budgets 0
and 1, on both substrates (``"torch"``, and ``"cuda"`` answered by the
kernels' plain versions on the CPU, so its routing runs).  The overlay's
rank tables equal ``repro``'s; the overlay merge keeps ``lax.sort`` +
``lax.top_k``'s tie order at widths past the select kernel's 1,024-column
warp path.  A ``compact()`` in the middle of a keystroke stream loses no
keystroke, sessions and the scheduler migrate, and the handoff container
loads in both packages with the same answers.
"""

import numpy as np
import pytest
import torch

import repro_torch as rt
from repro.api import CompletionIndex as JaxIndex
from repro.api import IndexSpec as JaxSpec
from repro.api import build_index as jax_build
from repro.core import engine as jax_eng
from repro.core import make_rules as jax_rules
from repro_torch.core import engine as eng
from repro_torch.core.engine.substrate import get_substrate
from repro_torch.core.trie_build import make_rules
from repro_torch.data.strings import make_usps
from torch_fast_jit import fast_jax_jit  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

# small static widths: the overlay merge itself does not depend on them
SPEC = dict(frontier=8, gens=8, expand=2, max_steps=48)
K = 3

STRINGS = ["andrew pavlo", "andy gray", "android update", "william smith",
           "willow tree", "record entry", "rec room", "banana", "band"]
SCORES = [50, 40, 30, 20, 10, 60, 5, 15, 25]
RULES = [("andy", "andrew"), ("bill", "william"), ("rec", "record")]
QUERIES = ["an", "andy", "bill", "rec", "w", "ba", "record e", "zzz"]
# typo'd queries too: at edit budget 1 they reach the mutated strings
TYPO_QUERIES = ["andrw", "wiliam", "banan", "zz~trnd"]
#: one mutation batch: new strings (one reached through andy -> andrew),
#: a delete of a base hit and a re-score (a tombstone and a carry)
BATCH = [("insert", "andrew zimmer", 70), ("insert", "zz~trending", 999),
         ("delete", "record entry", None), ("update_score", "banana", 500)]
SUBSTRATES = ["torch", "cuda"]


def _rules(kind):
    return [] if kind == "plain" else RULES


def _build(strings=STRINGS, scores=SCORES, kind="et", substrate="torch",
           **kw):
    return rt.build_index(strings, scores, make_rules(_rules(kind)),
                          rt.IndexSpec(kind=kind, substrate=substrate,
                                       **dict(SPEC, **kw)), device="cpu")


def _jax_build(strings=STRINGS, scores=SCORES, kind="et", **kw):
    return jax_build(strings, scores, jax_rules(_rules(kind)),
                     JaxSpec(kind=kind, substrate="jnp", **dict(SPEC, **kw)))


def _apply(idx, ops):
    for op, s, score in ops:
        if op == "delete":
            idx.delete(s)
        else:
            getattr(idx, op)(s, score)
    return idx


def _rebuilt(idx):
    """The differential reference: a from-scratch build over the index's
    live contents, same rules and spec."""
    live = idx.live_items()
    strings = sorted(live)
    return rt.build_index(strings, [live[s] for s in strings], idx.rules,
                          idx.spec, device="cpu")


def _assert_matches_rebuild(idx, queries=QUERIES, k=K):
    assert idx.complete(queries, k=k) == _rebuilt(idx).complete(queries, k=k)


# -- every kind, layout, cache and edit budget ---------------------------------

MATRIX = [(kind, comp, cache, e) for kind in ("plain", "tt", "et", "ht")
          for comp in ("none", "packed") for cache in (0, 4) for e in (0, 1)]
# a covering subset held against repro too: every kind, layout, cache
# depth and edit budget appears (repro compiles each index's shapes)
JAX_MATRIX = [("et", "packed", 4, 1), ("tt", "none", 0, 1),
              ("ht", "packed", 0, 0), ("plain", "none", 4, 0)]


def _case_id(c):
    return f"{c[0]}-{c[1]}-cache{c[2]}-E{c[3]}"


@pytest.mark.parametrize("substrate", SUBSTRATES)
@pytest.mark.parametrize("case", MATRIX, ids=[_case_id(c) for c in MATRIX])
def test_mutations_match_rebuild_across_matrix(case, substrate):
    kind, comp, cache, e = case
    idx = _apply(_build(kind=kind, substrate=substrate, compression=comp,
                        cache_k=cache, edit_budget=e), BATCH)
    assert idx.has_mutations and idx.mutation_backlog == 5
    queries = QUERIES + (TYPO_QUERIES if e else [])
    _assert_matches_rebuild(idx, queries)
    # k past the cache depth and the over-fetch: the beam under the merge
    _assert_matches_rebuild(idx, queries, k=7)


@pytest.mark.parametrize("case", JAX_MATRIX,
                         ids=[_case_id(c) for c in JAX_MATRIX])
def test_mutations_match_repro(case):
    kind, comp, cache, e = case
    kw = dict(compression=comp, cache_k=cache, edit_budget=e)
    j = _apply(_jax_build(kind=kind, **kw), BATCH)
    queries = QUERIES + (TYPO_QUERIES if e else [])
    want = j.complete(queries, k=K)
    for sub in SUBSTRATES:
        p = _apply(_build(kind=kind, substrate=sub, **kw), BATCH)
        assert p.complete(queries, k=K) == want, sub
        assert p.live_strings == j.live_strings
        assert p.live_items() == j.live_items()


# -- overlay semantics (state against repro, answers against the rebuild) ------


def _both(ops):
    """The port's and repro's index after the same ops (repro builds no
    device state for these)."""
    return _apply(_build(), ops), _apply(_jax_build(), ops)


def test_synonym_rule_reaches_overlay_insert():
    """Overlay hits obey the rules as base hits do: an inserted string
    surfaces for a query that matches it only through a rewrite."""
    idx = _build()
    idx.insert("andrew zimmer", 999)
    assert idx.complete(["andy"], k=K)[0][0] == (999, "andrew zimmer")
    _assert_matches_rebuild(idx, ["andy", "andy z", "andr"])


@pytest.mark.parametrize("substrate", SUBSTRATES)
def test_insert_is_upsert(substrate):
    idx = _build(substrate=substrate)
    idx.insert("banana", 1)                # demote an existing string
    idx.insert("banana", 777)              # then re-score the re-score
    assert idx.live_items()[b"banana"] == 777
    j = _jax_build()
    j.insert("banana", 1)
    j.insert("banana", 777)
    assert idx.live_items() == j.live_items()
    assert idx.mutation_backlog == j.mutation_backlog == 2
    _assert_matches_rebuild(idx)


def test_delete_raises_on_missing_and_double_delete():
    for idx in _both([]):
        with pytest.raises(KeyError):
            idx.delete("never there")
        idx.delete("banana")
        with pytest.raises(KeyError):
            idx.delete("banana")
        idx.insert("banana", 9)            # resurrect, then delete again
        idx.delete("banana")
        assert b"banana" not in idx.live_items()
    p, j = _both([("delete", "banana", None), ("insert", "banana", 9),
                  ("delete", "banana", None)])
    assert p.live_items() == j.live_items()
    assert p.mutation_backlog == j.mutation_backlog
    _assert_matches_rebuild(p)


def test_update_score_requires_live_string():
    for idx in _both([]):
        with pytest.raises(KeyError, match="use insert"):
            idx.update_score("never there", 5)
        idx.delete("banana")
        with pytest.raises(KeyError, match="use insert"):
            idx.update_score("banana", 5)


def test_rejects_empty_string_and_negative_score():
    for idx in _both([]):
        with pytest.raises(ValueError, match="empty string"):
            idx.insert("", 5)
        with pytest.raises(ValueError, match="non-negative"):
            idx.insert("fine", -1)
        assert not idx.has_mutations


def test_insert_then_delete_cancels_out():
    baseline = _build().complete(QUERIES, k=K)
    p, j = _both([("insert", "zz~ephemeral", 999),
                  ("delete", "zz~ephemeral", None)])
    assert not p.has_mutations and not j.has_mutations
    assert p.live_strings is p.strings
    assert p.complete(QUERIES, k=K) == baseline


@pytest.mark.parametrize("seed", range(4))
def test_refresh_tables_match_repro(seed):
    """Random mutation batches on USPS 400 (collisions with base strings
    and with each other): the dead mask, the global ranks of base and
    overlay strings and the live list equal repro's refresh."""
    ds = make_usps(400, seed=0)
    rng = np.random.default_rng(seed)
    p = rt.build_index(ds.strings, ds.scores, make_rules(ds.rules),
                       kind="et", device="cpu")
    base = [s.decode() for s in p.strings]
    ops = []
    for _ in range(int(rng.integers(5, 40))):
        r = rng.random()
        s = base[int(rng.integers(len(base)))]
        if r < 0.4:
            ops.append(("insert", s[:int(rng.integers(3, len(s) + 1))],
                        int(rng.integers(0, 50_000))))
        elif r < 0.7:
            ops.append(("delete", s, None))
        else:
            ops.append(("update_score", s, int(rng.integers(0, 50_000))))
    j = jax_build(ds.strings, ds.scores, jax_rules(ds.rules),
                  JaxSpec(kind="et", substrate="jnp"))
    for idx in (p, j):
        for op, s, score in ops:
            try:
                _apply(idx, [(op, s, score)])
            except KeyError:
                pass
    pov, jov = p._overlay, j._overlay
    pov.refresh(p)
    jov.refresh(j)
    assert pov.live == jov.live
    assert np.array_equal(pov.base_dead, jov.base_dead)
    assert pov.base_grank.dtype == np.int32
    assert np.array_equal(pov.base_grank, jov.base_grank)
    assert np.array_equal(pov.ov_grank, jov.ov_grank)
    assert pov.ov_grank.dtype == jov.ov_grank.dtype == np.int32


@pytest.mark.parametrize("C,k", [(1025, 10), (2048, 10), (2048, 1024),
                                 (40, 10), (1024, 10)])
@pytest.mark.parametrize("substrate", SUBSTRATES)
def test_merge_past_warp_width_keeps_repro_tie_order(substrate, C, k):
    """merge_overlay_topk on rows of heavy score ties, shuffled granks,
    INT_MAX/-1 sentinel slots and rows with fewer valid slots than k:
    equal to repro's (lax.sort + lax.top_k) at widths on both sides of
    the select kernel's 1,024-column warp path."""
    rng = np.random.default_rng(C + k)
    B = 6
    scores = rng.integers(0, 4, (B, C)).astype(np.int32)
    granks = np.stack([rng.permutation(4 * C)[:C] for _ in range(B)]
                      ).astype(np.int32)
    invalid = rng.random((B, C)) < 0.2
    invalid[-1, k // 2:] = True            # fewer valid slots than k
    scores[invalid] = -1
    granks[invalid] = eng.INT_MAX
    got = eng.merge_overlay_topk(torch.from_numpy(scores),
                                 torch.from_numpy(granks), k,
                                 get_substrate(substrate))
    want = jax_eng.merge_overlay_topk(scores, granks, k,
                                      jax_eng.get_substrate("jnp"))
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        assert np.array_equal(g.numpy(), np.asarray(w))


# -- compaction / hot-swap -----------------------------------------------------


def test_save_with_mutations_refuses(tmp_path):
    idx = _build()
    idx.insert("zz~pending", 1)
    with pytest.raises(ValueError, match="uncompacted mutations"):
        idx.save(str(tmp_path / "x.npz"))


@pytest.mark.parametrize("compression", ["none", "packed"])
@pytest.mark.parametrize("substrate", SUBSTRATES)
def test_compact_folds_overlay_and_bumps_epoch(substrate, compression):
    idx = _apply(_build(substrate=substrate, compression=compression,
                        cache_k=4), BATCH)
    before = idx.complete(QUERIES, k=K)
    old_tensors, epoch0 = idx.tensors, idx.epoch
    idx.compact()
    assert idx.epoch == epoch0 + 1
    assert not idx.has_mutations and idx.mutation_backlog == 0
    assert b"andrew zimmer" in idx.strings         # folded into the base
    assert b"record entry" not in idx.strings
    assert idx.tensors is not old_tensors
    assert idx.substrate == substrate and idx.compression == compression
    assert idx.complete(QUERIES, k=K) == before    # answers are invariant
    _assert_matches_rebuild(idx)


def test_compact_handoff_loads_in_both_packages(tmp_path):
    """The folded container the port writes loads in repro and in the
    port, and both answer as the swapped-in index."""
    path = str(tmp_path / "folded.npz")
    idx = _apply(_build(cache_k=4), BATCH)
    idx.insert("zz~persisted", 42)
    idx.reconfigure(substrate="cuda")
    idx.compact(handoff_path=path)
    assert idx.substrate == "cuda"         # the raced knob re-applied
    queries = QUERIES + ["zz"]
    want = idx.complete(queries, k=K)
    assert rt.CompletionIndex.load(path, device="cpu").complete(
        queries, k=K) == want
    loaded = JaxIndex.load(path)
    assert loaded.epoch == 0 and loaded.strings == idx.strings
    assert loaded.reconfigure(substrate="jnp").complete(queries, k=K) == want
    j = _apply(_jax_build(cache_k=4), BATCH)
    j.insert("zz~persisted", 42)
    assert j.complete(queries, k=K) == want


def test_epoch_survives_save_load(tmp_path):
    path = str(tmp_path / "epoch.npz")
    idx = _build()
    idx.insert("zz~x", 1)
    idx.compact()
    assert idx.epoch == 1
    idx.save(path)
    assert rt.CompletionIndex.load(path, device="cpu").epoch == 1
    assert JaxIndex.load(path).epoch == 1


def test_mutations_after_prepare_survive_the_swap():
    """apply_compaction re-applies whatever landed after the snapshot as
    a fresh overlay — the racy half of a background compaction — and a
    reconfigure that raced it."""
    idx = _build()
    idx.insert("zz~early", 10)
    prepared = idx.prepare_compaction()
    idx.insert("zz~late", 20)              # lands between prepare and apply
    idx.delete("banana")
    idx.reconfigure(edit_budget=1)
    idx.apply_compaction(prepared)
    assert b"zz~early" in idx.strings      # folded by the prepare
    assert idx.has_mutations               # the late pair re-applied on top
    live = idx.live_items()
    assert live[b"zz~late"] == 20 and b"banana" not in live
    assert idx.cfg.edit_budget == 1 and idx.spec.edit_budget == 1
    assert idx.epoch == 3        # reconfigure, swap, reconfigure re-applied
    _assert_matches_rebuild(idx, QUERIES + TYPO_QUERIES)
    j = _jax_build()
    j.insert("zz~early", 10)
    jp = j.prepare_compaction()
    j.insert("zz~late", 20)
    j.delete("banana")
    j.apply_compaction(jp)
    assert j.live_items() == live and j.strings == idx.strings


# -- epoch migration under live sessions ---------------------------------------


@pytest.mark.parametrize("substrate", SUBSTRATES)
def test_session_answers_through_overlay_then_migrates(substrate):
    idx = _build(substrate=substrate, cache_k=4)
    sess = idx.session(k=K)
    sess.type("an")
    idx.insert("antelope", 999)
    # pending mutations route the session through the merged one-shot
    # path at once — no compact needed to see the insert
    assert sess.topk()[0] == (999, "antelope")
    epoch0 = idx.epoch
    idx.compact()
    assert idx.epoch == epoch0 + 1
    # the next keystroke migrates: replayed prefix, fresh epoch
    assert sess.type("t") == idx.complete(["ant"], k=K)[0]
    assert sess._epoch == idx.epoch
    j = _jax_build(cache_k=4)
    js = j.session(k=K)
    js.type("an")
    j.insert("antelope", 999)
    j.compact()
    assert js.type("t") == idx.complete(["ant"], k=K)[0]


def test_session_backspace_after_hot_swap():
    idx = _build()
    sess = idx.session(k=K)
    sess.type("and")
    idx.insert("zz~x", 1)
    idx.compact()
    assert sess.backspace() == idx.complete(["an"], k=K)[0]


@pytest.mark.parametrize("compression", ["none", "packed"])
@pytest.mark.parametrize("substrate", SUBSTRATES)
def test_scheduler_hot_swap_mid_stream(substrate, compression):
    """A compact() under a live scheduler loses no keystroke and changes
    no answer: only zz-prefixed strings are mutated, so every typed
    prefix's expected results equal a mutation-free baseline."""
    baseline = _build(substrate=substrate, compression=compression,
                      cache_k=4)
    idx = _build(substrate=substrate, compression=compression, cache_k=4)
    svc = rt.CompletionService(idx, batching=True, block=4,
                               max_wait_ms=1000.0)
    texts = ["andy p", "willow", "record", "banana"]
    sessions = [svc.open_session(k=K) for _ in texts]
    tickets = []
    for step in range(max(len(t) for t in texts)):
        if step == 2:                         # mutations land mid-stream
            idx.insert("zz~hot-1", 901)
            idx.insert("zz~hot-2", 902)
            idx.delete("zz~hot-2")
        if step == 4:                         # hot-swap mid-stream
            svc.compact()
        for sess, text in zip(sessions, texts):
            if step < len(text):
                tickets.append((sess.submit(text[step]), text[:step + 1]))
    svc.drain()
    assert svc.scheduler.stats.migrations >= 1
    assert all(t.done for t, _ in tickets)
    assert sum(t.results is None for t, _ in tickets) == 0
    expected = {p: baseline.complete([p], k=K)[0]
                for p in {p for _, p in tickets}}
    for t, p in tickets:
        assert t.results == expected[p], p
    assert b"zz~hot-1" in idx.strings         # the compact really folded
    # a second swap with sessions still open: they keep answering
    idx.insert("zz~hot-3", 5)
    idx.compact()
    assert sessions[0].type("a") == baseline.complete(["andy pa"], k=K)[0]
    assert svc.scheduler.stats.migrations >= 2


@pytest.mark.parametrize("swap", ["service", "index"])
@pytest.mark.parametrize("compression", ["none", "packed"])
@pytest.mark.parametrize("substrate", SUBSTRATES)
def test_scheduler_hot_swap_shifting_sids(substrate, compression, swap):
    """A swap that renumbers the base: a delete of the string that sorts
    first and an insert sorting before every other string move every sid,
    so the flush whose results are stashed across the swap (computed on
    the old epoch's tables) must not be decoded against the new
    dictionary.  Every ticket equals a rebuild over the live strings."""
    idx = _build(substrate=substrate, compression=compression, cache_k=4)
    idx.delete("andrew pavlo")
    idx.insert("aaa first", 45)
    expected = _rebuilt(idx)
    svc = rt.CompletionService(idx, batching=True, block=4,
                               max_wait_ms=1000.0)
    texts = ["andy p", "willow", "record", "banana"]
    sessions = [svc.open_session(k=K) for _ in texts]
    tickets = []
    for step in range(max(len(t) for t in texts)):
        if step == 3:
            assert svc.scheduler._unsettled   # a flush rides the swap
            (svc.compact() if swap == "service" else idx.compact())
        for sess, text in zip(sessions, texts):
            if step < len(text):
                tickets.append((sess.submit(text[step]), text[:step + 1]))
    svc.drain()
    assert svc.scheduler.stats.migrations == 1
    assert idx.strings[0] == b"aaa first" and not idx.has_mutations
    want = expected.complete([p for _, p in tickets], k=K)
    assert [t.results for t, _ in tickets] == want


@pytest.mark.parametrize("substrate", SUBSTRATES)
def test_scheduler_answers_through_the_overlay(substrate):
    """With mutations pending every lane answers through the merged
    one-shot path (the slab's top-k sees the base alone), as repro's."""
    idx = _build(substrate=substrate, cache_k=4)
    svc = rt.CompletionService(idx, batching=True, block=2)
    a = svc.open_session(k=K)
    assert a.type("and") == idx.complete(["and"], k=K)[0]
    idx.insert("andes", 1000)
    got = a.type("e")
    assert got[0] == (1000, "andes")
    assert got == _rebuilt(idx).complete(["ande"], k=K)[0]
    j = _jax_build(cache_k=4)
    from repro.serving import CompletionService as JaxService

    ja = JaxService(j, batching=True, block=2).open_session(k=K)
    ja.type("and")
    j.insert("andes", 1000)
    assert ja.type("e") == got
