"""The port's index and service surface against the JAX package's.

``IndexSpec.memory_budget`` (validated, carried, no effect on the card),
``CompletionIndex.reconfigure`` (build-time fields rejected before
unknown ones, no-op changes dropped, an ``epoch`` bumped once per real
change), its deprecated aliases, and ``ServiceStats.mean_latency_ms`` /
``p99_ms()``: the same calls on both packages must accept or raise alike
and leave the same state.  Then the re-exports: ``repro_torch.api``,
``.core`` (lazily) and ``.kernels`` cover ``repro``'s names, the engine's
names are ``repro``'s with ``CudaSubstrate`` for ``PallasSubstrate``, the
deprecated ``core.api`` shim warns and exports as ``repro``'s, the ops
wrappers take ``repro``'s arguments, and the substrate registry raises as
``repro``'s does.  Nothing here runs a query, so no JAX code is compiled.
"""

from functools import lru_cache

import pytest

import repro_torch as rt
from repro.api import IndexSpec as JaxSpec
from repro.api import build_index as jax_build
from repro.core import make_rules as jax_rules
from repro.serving.completion_service import ServiceStats as JaxStats
from repro_torch.api.index import BUILD_FIELDS, RUNTIME_FIELDS
from repro_torch.core.trie_build import make_rules
from repro_torch.serving.completion_service import ServiceStats
from torch_threads import one_torch_thread  # noqa: F401

FIG1 = (["andrew pavlo", "andrew parker", "andrew packard", "william smith",
         "bill of rights"], [50, 40, 30, 20, 10],
        [("andy", "andrew"), ("bill", "william")])


def _outcome(fn):
    """("ok", value) or the exception's type and the words that tell the
    packages' messages apart."""
    try:
        return "ok", fn()
    except Exception as err:   # the outcome is what is compared
        msg = str(err)
        tag = next((w for w in ("build-time", "unknown", ">= 0", "positive")
                    if w in msg), "")
        return type(err).__name__, tag


@lru_cache(maxsize=None)
def _pair_data():
    return FIG1[0], FIG1[1]


def _pair(**spec):
    strings, scores = _pair_data()
    j = jax_build(strings, scores, jax_rules(FIG1[2]), kind="et", **spec)
    p = rt.build_index(strings, scores, make_rules(FIG1[2]), kind="et",
                       device="cpu", **spec)
    return j, p


def test_field_sets_match_repro():
    from repro.api import index as jindex

    assert RUNTIME_FIELDS == jindex.RUNTIME_FIELDS
    assert BUILD_FIELDS == jindex.BUILD_FIELDS
    assert {f for f in JaxSpec.__dataclass_fields__} == \
        {f for f in rt.IndexSpec.__dataclass_fields__}


SPEC_CASES = [dict(memory_budget=4096), dict(memory_budget=0),
              dict(memory_budget=-1), dict(cache_k=-1), dict(multiterm_gap=0),
              dict(multiterm_gap=1), dict(multiterm_gap=3),
              dict(frontier=0), dict(memory_budget=1 << 30, edit_budget=1)]


@pytest.mark.parametrize("spec", SPEC_CASES,
                         ids=[",".join(f"{k}={v}" for k, v in s.items())
                              for s in SPEC_CASES])
def test_spec_and_build_accept_or_raise_as_repro(spec):
    strings, scores = _pair_data()
    want = _outcome(lambda: JaxSpec(**spec).validate() and None)
    assert _outcome(lambda: rt.IndexSpec(**spec).validate() and None) == want
    j = _outcome(lambda: jax_build(strings, scores, [], kind="et",
                                   **spec).memory_budget)
    p = _outcome(lambda: rt.build_index(strings, scores, [], kind="et",
                                        device="cpu", **spec).memory_budget)
    assert p == j
    if p[0] == "ok":
        idx = rt.build_index(strings, scores, [], kind="et", device="cpu",
                             **spec)
        assert idx.cfg.memory_budget == idx.spec.memory_budget == p[1]


RECONFIGURE_SEQUENCES = {
    "memory_budget": [dict(memory_budget=4096), dict(memory_budget=4096),
                      dict(memory_budget=0), dict(memory_budget=-1)],
    "no_ops": [dict(frontier=32), dict(substrate="auto"), dict(),
               dict(gens=48, expand=8), dict(edit_budget=0)],
    "widths": [dict(frontier=64, gens=48), dict(frontier=64, gens=96),
               dict(max_steps=0), dict(edit_budget=2), dict(edit_budget=3)],
    "build_time_first": [dict(kind="tt"), dict(cache_k=4, bogus=1),
                         dict(multiterm_gap=3), dict(compression="packed"),
                         dict(alpha=0.1, frontier=64), dict(bogus=1),
                         dict(frontier=64, bogus=1), dict(frontier=64)],
}


@pytest.mark.parametrize("name", sorted(RECONFIGURE_SEQUENCES))
def test_reconfigure_sequences_match_repro(name):
    """Step by step: the same accept or raise, the same epoch, the same
    runtime fields in the spec and the config."""
    j, p = _pair()
    assert j.epoch == p.epoch == 0
    for step in RECONFIGURE_SEQUENCES[name]:
        got_j = _outcome(lambda: j.reconfigure(**step) and None)
        got_p = _outcome(lambda: p.reconfigure(**step) and None)
        assert got_p == got_j, step
        assert p.epoch == j.epoch, step
        for f in RUNTIME_FIELDS:
            if f != "substrate":   # the two packages name theirs apart
                assert getattr(p.spec, f) == getattr(j.spec, f), (step, f)
                assert getattr(p.cfg, f) == getattr(j.cfg, f), (step, f)
    assert p.memory_budget == j.memory_budget


def test_deprecated_aliases_match_repro():
    j, p = _pair()
    for idx, sub in ((j, "jnp"), (p, "torch")):
        with pytest.warns(DeprecationWarning, match="set_memory_budget"):
            assert idx.set_memory_budget(4096) is idx
        with pytest.warns(DeprecationWarning, match="set_memory_budget"):
            idx.set_memory_budget(4096)             # a no-op: no bump
        with pytest.warns(DeprecationWarning, match="set_substrate"):
            assert idx.set_substrate(sub) is idx
        with pytest.warns(DeprecationWarning, match="set_substrate"):
            idx.set_substrate(sub)
    assert p.epoch == j.epoch == 2
    assert p.memory_budget == j.memory_budget == 4096
    assert p.substrate == "torch"


@pytest.mark.parametrize("latencies", [[], [3.0], [1.0, 2.0, 4.0, 8.0],
                                       [0.5 * i for i in range(1, 301)]])
def test_service_stats_match_repro(latencies):
    """A fixed latency list folded into both packages' stats: the same
    mean (total seconds over queries) and p99."""
    kw = dict(n_queries=len(latencies) * 4,
              total_seconds=sum(latencies) * 4 / 1e3,
              batches=len(latencies), latencies_ms=list(latencies))
    j, p = JaxStats(**kw), ServiceStats(**kw)
    assert p.mean_latency_ms == j.mean_latency_ms
    assert p.p99_ms() == j.p99_ms() == p.p99_latency_ms
    assert p.p50_latency_ms == j.p50_latency_ms


def test_service_records_mean_latency():
    idx = rt.build_index(*_pair_data(), [], device="cpu")
    service = rt.CompletionService(idx)
    service.complete(["and", "wil"], k=2)
    service.complete(["bill"], k=2)
    st = service.stats
    assert st.n_queries == 3 and st.batches == 2
    assert st.mean_latency_ms == pytest.approx(st.total_seconds / 3 * 1e3)
    assert st.p99_ms() == max(st.latencies_ms)


# ---------------------------------------------------------------------------
# the public surface's re-exports, against repro's
# ---------------------------------------------------------------------------


def _fresh_import(name):
    """Import ``name`` anew (its warnings raised again) and return it with
    the warnings its import raised."""
    import importlib
    import sys
    import warnings

    sys.modules.pop(name, None)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        mod = importlib.import_module(name)
    return mod, [w for w in caught
                 if issubclass(w.category, DeprecationWarning)]


@pytest.mark.parametrize("ours,theirs", [
    ("repro_torch.api", "repro.api"),
    ("repro_torch.core", "repro.core"),
    ("repro_torch.kernels", "repro.kernels")])
def test_package_exports_cover_repros(ours, theirs):
    import importlib

    mine, ref = importlib.import_module(ours), importlib.import_module(theirs)
    assert set(ref.__all__) <= set(mine.__all__)
    for name in mine.__all__:
        assert getattr(mine, name) is not None, name


def test_engine_exports_match_repros():
    import repro.core.engine as jeng
    import repro_torch.core.engine as eng

    want = set(jeng.__all__) - {"PallasSubstrate"} | {"CudaSubstrate"}
    assert set(eng.__all__) == want
    assert eng.CudaSubstrate().name == "cuda"
    assert issubclass(eng.CudaSubstrate, eng.Substrate)
    assert eng.get_substrate("torch").__class__ is eng.Substrate


def test_core_resolves_the_api_lazily_without_warning():
    import warnings

    import repro_torch.api as api
    import repro_torch.core as core

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        for name in ("BuildStats", "CompletionIndex", "IndexSpec",
                     "Session", "build_index"):
            assert getattr(core, name) is getattr(api, name)
    with pytest.raises(AttributeError):
        core.not_a_name


def test_core_api_shim_warns_and_exports_as_repros():
    ours, ours_warned = _fresh_import("repro_torch.core.api")
    theirs, theirs_warned = _fresh_import("repro.core.api")
    assert len(ours_warned) == len(theirs_warned) == 1
    assert "repro_torch.api" in str(ours_warned[0].message)
    assert ours.__all__ == theirs.__all__
    import repro_torch.api.index as index

    assert ours._to_device is index._to_device


@pytest.mark.parametrize("name", ["trie_walk", "locus_walk", "beam_topk",
                                  "topk_select", "cached_topk_merge",
                                  "cached_topk_merge_packed",
                                  "candidate_topk", "embedding_bag",
                                  "embedding_bag_dense"])
def test_ops_wrappers_take_repros_arguments(name):
    import inspect

    from repro.kernels import ops as jops
    from repro_torch.kernels import ops

    ours = inspect.signature(getattr(ops, name)).parameters
    theirs = inspect.signature(getattr(jops, name)).parameters
    if name in ("embedding_bag", "embedding_bag_dense", "candidate_topk"):
        # the off-path wrappers do not take repro's block_* tiling (each
        # CUDA kernel plans its own launch)
        theirs = {k: v for k, v in theirs.items()
                  if not k.startswith("block")}
        ours = {k: v for k, v in ours.items() if not k.startswith("block")}
    assert [(p.name, p.default) for p in ours.values()] == \
        [(p.name, p.default) for p in theirs.values()]


@pytest.mark.parametrize("name", ["torch", "cuda", "new"])
def test_register_substrate_as_repro(name):
    from repro.core.engine import substrate as jsub
    from repro_torch.core.engine import substrate as sub

    jname = {"torch": "jnp", "cuda": "pallas"}.get(name, "test-new")
    pname = name if name != "new" else "test-new"
    if name == "new":
        try:
            assert sub.register_substrate(pname, sub.Substrate()) is \
                sub.get_substrate(pname)
            assert jsub.register_substrate(jname, jsub.Substrate()) is \
                jsub.get_substrate(jname)
            assert pname in sub.available_substrates()
            assert jname in jsub.available_substrates()
        finally:
            sub._SUBSTRATES.pop(pname, None)
            jsub._SUBSTRATES.pop(jname, None)
        assert pname not in sub.available_substrates()
        return
    with pytest.raises(ValueError, match="already registered"):
        jsub.register_substrate(jname, jsub.Substrate())
    with pytest.raises(ValueError, match="already registered"):
        sub.register_substrate(pname, sub.Substrate())
    with pytest.raises(ValueError, match="unknown substrate"):
        jsub.get_substrate("nope")
    with pytest.raises(ValueError, match="unknown substrate"):
        sub.get_substrate("nope")
    assert sub.TorchSubstrate is sub.Substrate
