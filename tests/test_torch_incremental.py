"""Typing sessions, the engine layer and the service: the port's
incremental locus DP (``core/engine/incremental.py``) against the JAX
package's, lane for lane and field for field; a ``reconfigure`` in the
middle of a session; and ``ServiceSession``'s keystroke stats.  Every
compared value is an int32 state, locus, score, id or flag: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch as rt
from repro.api import IndexSpec as JaxSpec
from repro.api import build_index as jax_build
from repro.core import engine as jeng
from repro.core import make_rules as jax_rules
from repro.serving.completion_service import CompletionService as JaxService
from repro.serving.completion_service import ServiceStats as JaxStats
from repro_torch.core import engine as eng
from repro_torch.core.alphabet import pad_queries
from repro_torch.core.engine import locus
from repro_torch.core.trie_build import make_rules
from repro_torch.serving.completion_service import ServiceStats
from torch_fast_jit import fast_jax_jit  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

K = 3
FIG1 = (["andrew pavlo", "andrew parker", "andrew packard", "william smith",
         "bill of rights"], [50, 40, 30, 20, 10],
        [("andy", "andrew"), ("bill", "william")])


def _pair(kind, **kw):
    strings, scores, rules = FIG1
    rules = rules if kind != "plain" else []
    j = jax_build(strings, scores, jax_rules(rules),
                  JaxSpec(kind=kind, substrate="jnp", **kw))
    p = rt.build_index(strings, scores, make_rules(rules),
                       rt.IndexSpec(kind=kind, **kw), device="cpu")
    return j, p


RECONFIGURES = [dict(edit_budget=1), dict(frontier=64, gens=96)]


def test_reconfigure_mid_session_migrates_as_repro():
    j, p = _pair("tt")
    js, ps = j.session(k=K), p.session(k=K)
    assert ps.type("andy") == js.type("andy")
    for change, more in zip(RECONFIGURES, [" pa", "v"]):
        j.reconfigure(**change)
        p.reconfigure(**change)
        assert p.epoch == j.epoch
        assert ps.type(more) == js.type(more), change
        assert ps._epoch == js._epoch == p.epoch
        assert ps.backspace(1) == js.backspace(1), change
    assert ps.topk(k=2) == js.topk(k=2)


# -- the engine layer ----------------------------------------------------------

ENGINE_CASES = [("tt", {}), ("et-E1", dict(edit_budget=1)),
                ("ht-packed-E2", dict(compression="packed", edit_budget=2))]


def _engine_pair(name, kw):
    return _pair(name.split("-")[0], **kw)


def _assert_state_equal(got, want, what):
    for f in ("rows", "rnodes", "overflow", "length"):
        np.testing.assert_array_equal(
            getattr(got, f).numpy(), np.asarray(getattr(want, f)),
            err_msg=f"{what}: {f}")


@pytest.mark.parametrize("name,kw", ENGINE_CASES,
                         ids=[c[0] for c in ENGINE_CASES])
def test_advance_loci_batch_matches_repro_lane_for_lane(name, kw):
    """Four lanes typing different queries, some lanes idle (c = -1) at
    some steps: every field of every lane after every step equals
    ``repro``'s vmapped advance, and the batched top-k equals
    ``repro``'s."""
    j, p = _engine_pair(name, kw)
    jt, jcfg, t, cfg = j.device, j.cfg, p.tensors, p.cfg
    lanes = [b"andy p", b"bill s", b"wxyz", b"andrw"]
    chars = np.full((8, len(lanes)), -1, np.int32)
    for b, q in enumerate(lanes):
        steps = [i for i in range(8) if (i + b) % 4 != 3][:len(q)]
        chars[steps, b] = list(q)
    jadv = jax.jit(lambda s, c: jeng.advance_loci_batch(jt, jcfg, s, c))
    jtop = jax.jit(lambda s: jeng.topk_from_loci_batch(jt, jcfg, s, K))
    js = jeng.init_locus_batch(jt, jcfg, len(lanes))
    ps = eng.init_locus_batch(t, cfg, len(lanes))
    _assert_state_equal(ps, js, "init")
    for i, row in enumerate(chars):
        js = jadv(js, jnp.asarray(row))
        ps = eng.advance_loci_batch(t, cfg, ps, torch.from_numpy(row))
        _assert_state_equal(ps, js, f"step {i}")
        for a, b_, nm in zip(eng.topk_from_loci_batch(t, cfg, ps, K),
                             jtop(js), ("scores", "sids", "exact")):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b_),
                                          err_msg=f"step {i} {nm}")
    # each lane alone, through the single-state form, lands on its lane
    for b in range(len(lanes)):
        st = eng.init_locus_state(t, cfg)
        for row in chars:
            st = eng.advance_locus_state(t, cfg, st, int(row[b]))
        for f in ("rows", "rnodes", "overflow", "length"):
            assert torch.equal(getattr(st, f), getattr(ps, f)[b]), (b, f)


@pytest.mark.parametrize("name,kw", ENGINE_CASES,
                         ids=[c[0] for c in ENGINE_CASES])
def test_topk_from_loci_batch_is_phase2_on_finalized_loci(name, kw):
    _, p = _engine_pair(name, kw)
    t, cfg = p.tensors, p.cfg
    states = eng.init_locus_batch(t, cfg, 3)
    for row in ([97, 98, 119], [110, 105, 105], [100, -1, 108]):
        states = eng.advance_loci_batch(t, cfg, states, row)
    got = eng.topk_from_loci_batch(t, cfg, states, K)
    loci = locus.finalize_loci(
        t, locus.decode_states(states.rows[:, 0], cfg.edit_budget)[0])
    s, i, e = eng.topk_phase2_batch(t, cfg, loci, K)
    assert torch.equal(got[0], s) and torch.equal(got[1], i)
    assert torch.equal(got[2], e & (states.overflow == 0))
    one = eng.topk_from_loci(t, cfg, _lane_of(states, 1), K)
    s1, i1, e1 = eng.topk_phase2(t, cfg, loci[1], K)
    assert torch.equal(one[0], s1) and torch.equal(one[1], i1)


def _lane_of(states, b):
    return eng.LocusState(*(x[b] for x in states))


@pytest.mark.parametrize("name,kw", ENGINE_CASES + [("plain", {})],
                         ids=[c[0] for c in ENGINE_CASES] + ["plain"])
def test_advance_loci_over_a_query_is_the_locus_dp(name, kw):
    """Mirror of ``repro``'s scan test: a -1 padded char vector lands on
    the one-shot DP's loci and top-k (the pads are no-ops)."""
    _, p = _engine_pair(name, kw)
    t, cfg = p.tensors, p.cfg
    for q in ("andy pa", "bill", "a", "xyz", "andrw p", ""):
        qs, qlens = pad_queries([q], 8)
        qs, qlens = torch.from_numpy(qs), torch.from_numpy(qlens)
        st = eng.advance_loci(t, cfg, eng.init_locus_state(t, cfg), qs[0])
        assert int(st.length) == len(q)
        loci, overflow = locus.locus_dp(t, cfg, qs, qlens)
        got = locus.finalize_loci(
            t, locus.decode_states(st.rows[0][None], cfg.edit_budget)[0])
        assert torch.equal(got, loci), q
        assert int(st.overflow) == int(overflow[0]), q
        inc = eng.topk_from_loci(t, cfg, st, K)
        one = eng.complete_one(t, cfg, qs[0], qlens[0], K)
        for a, b in zip(inc, one):
            assert torch.equal(a, b), q


# -- the service ---------------------------------------------------------------


def test_service_session_stats_count_as_repro():
    j, p = _pair("et")
    js, ps = JaxService(j), rt.CompletionService(p)
    a, b = js.open_session(k=K), ps.open_session(k=K)
    for op, arg in [("type", "andy"), ("type", ""), ("backspace", 2),
                    ("type", " p"), ("reset", None), ("type", "bil")]:
        want = getattr(a, op)(*([] if arg is None else [arg]))
        assert getattr(b, op)(*([] if arg is None else [arg])) == want
        assert b.prefix == a.prefix
        assert ps.stats.n_keystrokes == js.stats.n_keystrokes, op
        assert len(ps.stats.keystroke_latencies_ms) == \
            len(js.stats.keystroke_latencies_ms)
    assert ps.stats.n_keystrokes == 9
    assert ps.stats.mean_keystroke_ms > 0
    assert ps.stats.p99_keystroke_ms() >= ps.stats.p50_keystroke_ms() > 0
    assert ps.stats.n_queries == js.stats.n_queries == 0
    b.close()
    ps.stats.reset_keystrokes()
    js.stats.reset_keystrokes()
    assert ps.stats.n_keystrokes == 0 and not ps.stats.keystroke_latencies_ms


@pytest.mark.parametrize("samples", [[], [2.0], [1.0, 3.0, 0.5, 8.0],
                                     [0.01 * i for i in range(1, 5001)]])
def test_keystroke_stats_fold_as_repro(samples):
    """A fixed list of keystroke seconds folded into both packages'
    stats: the same count, total, window, mean, p50 and p99."""
    j, p = JaxStats(), ServiceStats()
    for x in samples:
        j.record_keystroke(x)
        p.record_keystroke(x)
    assert p.n_keystrokes == j.n_keystrokes
    assert p.keystroke_seconds == j.keystroke_seconds
    assert p.keystroke_latencies_ms == j.keystroke_latencies_ms
    assert p.mean_keystroke_ms == j.mean_keystroke_ms
    assert p.p50_keystroke_ms() == j.p50_keystroke_ms()
    assert p.p99_keystroke_ms() == j.p99_keystroke_ms()
