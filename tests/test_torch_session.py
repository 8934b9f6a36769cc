"""Typing sessions: the port's incremental engine and ``Session`` against
the JAX package's (``substrate="jnp"``) and against the port's own
one-shot ``complete``.

Per keystroke, the port's session on both substrates (``"torch"``, and
``"cuda"`` answered by the kernels' plain versions on the CPU, so its
routing runs), ``repro``'s session and the port's ``complete`` on the
prefix must give the same (score, string) list, for every kind, both
layouts, with and without a cache and at edit budgets 0-2; so must a
backspace over multi-byte UTF-8 characters.  The engine layer and the
service are in ``test_torch_incremental.py``.
"""

import pytest

import repro_torch as rt
from repro.api import IndexSpec as JaxSpec
from repro.api import build_index as jax_build
from repro.core import make_rules as jax_rules
from repro_torch.core import engine as eng
from repro_torch.core.trie_build import make_rules
from torch_fast_jit import fast_jax_jit  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

K = 3
FIG1 = (["andrew pavlo", "andrew parker", "andrew packard", "william smith",
         "bill of rights"], [50, 40, 30, 20, 10],
        [("andy", "andrew"), ("bill", "william")])
# rewritten, plain, typo'd (substitute, delete, insert) and unmatched
FIG1_QUERIES = ["andy pa", "bil s", "andrw p", "wiliam", "xyz"]
MT = ([b"the new york times", b"new york", b"san francisco giants",
       b"the giants", b"new jersey", b"times square"],
      [60, 50, 40, 30, 20, 10], [])
MT_QUERIES = ["the t", "the york t", "san g", "t", "new y"]
MT_SPEC = dict(frontier=32, gens=32, expand=4, max_steps=128)

# (id, corpus, kind, spec options): every kind, both layouts, with and
# without a cache, edit budgets 0-2, and a frontier too narrow for the
# corpus (inexact states: the session answers through complete).  At an
# edit budget of 2 the typo'd queries alone.
CASES = [
    ("plain", "fig1", "plain", {}),
    ("plain-packed-cache", "fig1", "plain",
     dict(compression="packed", cache_k=4)),
    ("plain-cache-E1", "fig1", "plain", dict(cache_k=4, edit_budget=1)),
    ("tt", "fig1", "tt", {}),
    ("tt-packed", "fig1", "tt", dict(compression="packed")),
    ("tt-packed-E1", "fig1", "tt", dict(compression="packed", edit_budget=1)),
    ("et", "fig1", "et", {}),
    ("et-cache", "fig1", "et", dict(cache_k=4)),
    ("et-packed-cache", "fig1", "et", dict(compression="packed", cache_k=4)),
    ("et-E1", "fig1", "et", dict(edit_budget=1)),
    ("et-cache-E2", "fig1", "et", dict(cache_k=4, edit_budget=2)),
    ("ht", "fig1", "ht", {}),
    ("ht-packed-E2", "fig1", "ht", dict(compression="packed", edit_budget=2)),
    ("multiterm", "mt", "multiterm", MT_SPEC),
    ("multiterm-packed-cache", "mt", "multiterm",
     dict(MT_SPEC, compression="packed", cache_k=4)),
    ("et-narrow", "fig1", "et", dict(frontier=1, gens=8, expand=4)),
]
E2_QUERIES = ["andrw pa", "wiliam"]


def _corpus(name):
    if name == "fig1":
        return FIG1[0], FIG1[1], FIG1[2], FIG1_QUERIES
    return MT[0], MT[1], MT[2], MT_QUERIES


def _pair(corpus, kind, **kw):
    strings, scores, rules, _ = _corpus(corpus)
    rules = rules if kind != "plain" else []
    j = jax_build(strings, scores, jax_rules(rules),
                  JaxSpec(kind=kind, substrate="jnp", **kw))
    p = rt.build_index(strings, scores, make_rules(rules),
                       rt.IndexSpec(kind=kind, **kw), device="cpu")
    return j, p


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_session_matches_repro_per_keystroke(case):
    _, corpus, kind, kw = case
    j, p = _pair(corpus, kind, **kw)
    queries = (E2_QUERIES if kw.get("edit_budget") == 2
               else _corpus(corpus)[3])
    js = j.session(k=K)
    sessions = {}
    for sub in ("torch", "cuda"):
        p.reconfigure(substrate=sub)
        sessions[sub] = p.session(k=K)
    p.reconfigure(substrate="torch")
    for q in queries:
        q = q.encode() if isinstance(q, str) else q
        js.reset()
        for s in sessions.values():
            s.reset()
        for i in range(len(q)):
            want = js.type(q[i:i + 1])
            assert p.complete([q[:i + 1]], k=K)[0] == want, (q, i)
            for sub, s in sessions.items():
                assert s.type(q[i:i + 1]) == want, (sub, q, i)


def test_narrow_frontier_leaves_states_inexact():
    """The narrow case above is there for the inexact fallback: its
    states do overflow."""
    _, p = _pair("fig1", "et", frontier=1, gens=8, expand=4)
    t, cfg = p.tensors, p.cfg
    overflowed = 0
    for q in FIG1_QUERIES:
        st = eng.advance_loci(t, cfg, eng.init_locus_state(t, cfg),
                              list(q.encode()))
        overflowed += int(st.overflow) > 0
    assert overflowed > 0


@pytest.mark.parametrize("kind", ["et", "tt"])
def test_backspace_over_utf8_matches_repro(kind):
    strings = ["café crème", "caffè latte", "naïve art", "日本語 text",
               "cafe noir"]
    scores = [50, 40, 30, 20, 10]
    rules = [("cafè", "café")]
    j = jax_build(strings, scores, jax_rules(rules),
                  JaxSpec(kind=kind, substrate="jnp"))
    p = rt.build_index(strings, scores, make_rules(rules), kind=kind,
                       device="cpu")
    js, ps = j.session(k=K), p.session(k=K)
    steps = [("type", "café"), ("backspace", 1), ("type", "è"),
             ("backspace", 2), ("type", "日本"), ("backspace", 1),
             ("type", "本語"), ("backspace", 9), ("backspace", 1),
             ("type", "naï"), ("backspace", 1), ("type", "ïve")]
    for op, arg in steps:
        want = getattr(js, op)(arg)
        assert getattr(ps, op)(arg) == want, (op, arg)
        assert ps.prefix == js.prefix, (op, arg)
        assert bytes(ps._prefix) == bytes(js._prefix)
