"""Multi-term completion (``kind="multiterm"``): the synthesized token-skip
rules, the synthesizer registry and the answers, against the JAX package.

``multiterm_rules`` must give ``repro``'s rules in ``repro``'s order (a
corpus with repeated grams, ``existing`` rules, gaps 1-3), and a
multiterm index must answer the JAX package's own multiterm example
(``MT_EXPECT`` of ``tests/test_modes.py``) as ``repro`` does, through
``complete`` and through a session, on both substrates and both layouts.
Answers are (score, string) lists, compared exactly.
"""

import pytest

import repro_torch as rt
from repro.api import IndexSpec as JaxSpec
from repro.api import build as jax_build_mod
from repro.api import build_index as jax_build
from repro.api import spec as jax_spec_mod
from repro.core import make_rules as jax_rules
from repro.data.strings import make_dblp, make_workload
from repro_torch.api import (get_synthesizer, multiterm_rules,
                             register_rule_synthesizer)
from repro_torch.core.trie_build import SynonymRule, make_rules
from torch_fast_jit import fast_jax_jit  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

K = 5
MT_STRINGS = [b"the new york times", b"new york", b"san francisco giants",
              b"the giants", b"new jersey", b"times square"]
MT_SCORES = [60, 50, 40, 30, 20, 10]
# repro's expectations (tests/test_modes.py): the last token completes
# against any token whose preceding tokens match, skipping up to
# multiterm_gap interior tokens
MT_EXPECT = {
    b"the t": [(60, "the new york times")],
    b"the times": [(60, "the new york times")],
    b"the york t": [(60, "the new york times")],
    b"new y": [(50, "new york")],
    b"san g": [(40, "san francisco giants")],
    b"the g": [(30, "the giants")],
    b"t": [(60, "the new york times"), (30, "the giants"),
           (10, "times square")],
}
MT_SPEC = dict(kind="multiterm", frontier=32, gens=32, expand=4,
               max_steps=128, multiterm_gap=2)
# repeated grams within and across strings, a one-token string, runs of
# spaces, str and bytes
GRAM_CORPUS = ["a b c d e", b"x b c y", "b c b c b c z", "solo",
               "  lead  and  trail  ", b"a b c d e", "p q r s t u v"]


def _key(rules):
    return [(r.lhs, r.rhs) for r in rules]


@pytest.mark.parametrize("gap", [1, 2, 3])
def test_multiterm_rules_match_repro(gap):
    existing = [(b" ", b" b c "), (b"and", b"&"), (b" ", b" q r s ")]
    for ex in ([], existing):
        got = multiterm_rules(GRAM_CORPUS, gap,
                              existing=[SynonymRule(*r) for r in ex])
        want = jax_build_mod.multiterm_rules(GRAM_CORPUS, gap,
                                             existing=jax_rules(ex))
        assert _key(got) == _key(want)
        assert len(set(_key(got))) == len(got)
        assert not set(_key(got)) & set(ex)


def test_synthesizer_registry_matches_repro():
    syn = get_synthesizer("multiterm")
    spec = rt.IndexSpec(**MT_SPEC)
    assert _key(syn(spec, MT_STRINGS, [])) == _key(
        jax_spec_mod.get_synthesizer("multiterm")(
            JaxSpec(**MT_SPEC), MT_STRINGS, []))
    for kind in ("et", "tt", "ht", "plain", "nosuch"):
        assert get_synthesizer(kind) is None
        assert jax_spec_mod.get_synthesizer(kind) is None
    for register in (register_rule_synthesizer,
                     jax_spec_mod.register_rule_synthesizer):
        with pytest.raises(ValueError, match="already registered"):
            register("multiterm")(lambda spec, strings, rules: [])


@pytest.mark.parametrize("compression", ["none", "packed"])
def test_mt_expect_on_both_substrates(compression):
    j = jax_build(MT_STRINGS, MT_SCORES, [],
                  JaxSpec(substrate="jnp", compression=compression,
                          **MT_SPEC))
    p = rt.build_index(MT_STRINGS, MT_SCORES, [], device="cpu",
                       compression=compression, **MT_SPEC)
    queries = list(MT_EXPECT)
    want = j.complete(queries, k=K)
    assert want == [MT_EXPECT[q] for q in queries]
    assert [(r.lhs, r.rhs) for r in p.rules] == \
        [(r.lhs, r.rhs) for r in j.rules]
    assert p.cfg.teleports == j.cfg.teleports > 0
    for sub in ("torch", "cuda"):
        p.reconfigure(substrate=sub)
        assert p.complete(queries, k=K) == want, sub
        for q in queries:
            sess = p.session(k=K)
            assert sess.type(q) == MT_EXPECT[q], (sub, q)
            assert sess.backspace(1) == p.complete([q[:-1]], k=K)[0], q


@pytest.mark.parametrize("gap", [1, 3])
def test_multiterm_gap_answers_match_repro(gap):
    ds = make_dblp(60, seed=0)
    spec = dict(MT_SPEC, multiterm_gap=gap)
    j = jax_build(ds.strings, ds.scores, jax_rules(ds.rules[:5]),
                  JaxSpec(substrate="jnp", **spec))
    p = rt.build_index(ds.strings, ds.scores, make_rules(ds.rules[:5]),
                       device="cpu", **spec)
    assert len(p.rules) == len(j.rules) > 5
    # the workload's queries, and two-token queries that skip a token
    toks = [s.split(" ") for s in ds.strings[:12]]
    skips = [f"{t[0]} {t[2][:2]}" for t in toks if len(t) > 3]
    queries = [q[:12] for q in make_workload(ds, 8, seed=1)] + skips
    assert p.complete(queries, k=K) == j.complete(queries, k=K)
