"""The plain version of each of the port's kernels against the JAX package.

Inputs are made with numpy from fixed seeds and go through the JAX
reference (``repro.core.engine.primitives`` and
``repro.kernels.ref.{trie_walk_ref, locus_walk_ref, beam_topk_ref}``) and
through the port's plain PyTorch version on the CPU.  Every output is an
integer (node ids, overflow counts, scores, string ids, exact flags), so
the tolerance is exact equality.  The CUDA kernels themselves are held
against these plain versions on the card by ``chip_smoke.py``.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch as rt
from repro.api import IndexSpec as JaxSpec
from repro.api import build_index as jax_build
from repro.core import make_rules
from repro.core.engine import primitives as jprim
from repro.data.strings import make_dblp, make_usps, make_workload
from repro.kernels import ref as jref
from repro_torch.core.alphabet import pad_queries
from repro_torch.core.engine import primitives as tprim
from repro_torch.core.engine.substrate import get_substrate
from repro_torch.kernels import beam_topk, locus_dp, ref as tref, trie_walk
from torch_fast_jit import fast_jax_jit  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

PAPER = (["andrew pavlo", "andrew parker", "andrew packard", "william smith",
          "bill of rights"], [50, 40, 30, 20, 10],
         [("andy", "andrew"), ("bill", "william")])
PAPER_QUERIES = ["andy pa", "andrew pa", "bil", "bill of", "a", "", "xyz"]


def _t(a):
    return torch.from_numpy(np.array(a))


# the references jitted once per (config, k): traced op by op they are slow
_locus_ref = jax.jit(jref.locus_walk_ref, static_argnums=1)
_beam_ref = jax.jit(jref.beam_topk_ref, static_argnums=(1, 3))


# -- primitives ---------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lower_bound_and_child_lookup(seed):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 6, 40)
    ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    chars = np.concatenate([np.sort(rng.choice(20, c, replace=False))
                            for c in counts]).astype(np.int32)
    children = rng.integers(0, 40, len(chars)).astype(np.int32)
    nodes = rng.integers(-1, 40, 64).astype(np.int32)
    ch = rng.integers(-1, 20, 64).astype(np.int32)
    iters = jprim.iters_for(len(chars))
    assert tprim.iters_for(len(chars)) == iters
    want = jprim.csr_child_lookup(jnp.asarray(ptr), jnp.asarray(chars),
                                  jnp.asarray(children), jnp.asarray(nodes),
                                  jnp.asarray(ch), iters)
    got = tprim.csr_child_lookup(_t(ptr), _t(chars), _t(children), _t(nodes),
                                 _t(ch), iters)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    n0 = np.maximum(nodes, 0)
    lo, hi = ptr[n0], ptr[n0 + 1]
    want = jprim.lower_bound(jnp.asarray(chars), jnp.asarray(lo),
                             jnp.asarray(hi), jnp.asarray(ch), iters)
    got = tprim.lower_bound(_t(chars), _t(lo), _t(hi), _t(ch), iters)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("width", [1, 3, 8, 40])
def test_dedup_pad(width):
    rng = np.random.default_rng(width)
    vec = rng.integers(-1, 12, (6, 24)).astype(np.int32)
    vec[0] = -1                                  # an empty row
    got, dropped = tprim.dedup_pad(_t(vec), width)
    for b in range(vec.shape[0]):
        w, d = jprim.dedup_pad(jnp.asarray(vec[b]), width)
        np.testing.assert_array_equal(np.asarray(w), got[b].numpy())
        assert int(d) == int(dropped[b])


# -- the plain kernels on built indexes -----------------------------------------


def _pair(strings, scores, rules, kind, **kw):
    rules = make_rules(rules) if kind != "plain" else []
    j = jax_build(strings, scores, rules,
                  JaxSpec(kind=kind, substrate="jnp", **kw))
    p = rt.build_index(strings, scores, rules, rt.IndexSpec(kind=kind, **kw),
                       device="cpu")
    return j, p


@pytest.fixture(scope="module")
def indexes():
    usps = make_usps(200, seed=0)
    dblp = make_dblp(150, seed=2)
    out = {}
    for kind in ("plain", "tt", "et", "ht"):
        out["paper", kind] = _pair(*PAPER, kind) + (PAPER_QUERIES,)
    for name, ds in (("usps", usps), ("dblp", dblp)):
        qs = [q[:8] for q in make_workload(ds, 5, seed=1)]
        for kind in ("plain", "tt", "et"):
            out[name, kind] = _pair(ds.strings, ds.scores, ds.rules,
                                    kind) + (qs,)
    return out


def _queries(qs):
    a, b = pad_queries(qs, 8)
    return a, b, _t(a), _t(b)


@pytest.mark.parametrize("case", [("paper", "plain"), ("usps", "plain"),
                                  ("dblp", "plain"), ("usps", "et")])
def test_trie_walk_plain(indexes, case):
    j, p, qs = indexes[case]
    qa, la, qt, lt = _queries(qs)
    d = j.device
    want = jref.trie_walk_ref(d.first_child, d.edge_char, d.edge_child,
                              jnp.asarray(qa), jnp.asarray(la))
    got = tref.trie_walk_ref(p.tensors.first_child, p.tensors.edge_char,
                             p.tensors.edge_child, qt, lt)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


LOCUS_CASES = [("paper", "tt", {}), ("paper", "ht", {}),
               ("paper", "ht", {"frontier": 1}), ("usps", "tt", {}),
               ("usps", "et", {"frontier": 2}), ("dblp", "et", {})]


@pytest.mark.parametrize("name,kind,widths", LOCUS_CASES)
def test_locus_dp_plain(indexes, name, kind, widths):
    j, p, qs = indexes[name, kind]
    qa, la, qt, lt = _queries(qs)
    jcfg = replace(j.cfg, **widths)
    want_loci, want_ov = _locus_ref(j.device, jcfg, jnp.asarray(qa),
                                    jnp.asarray(la))
    loci, ov = tref.locus_walk_ref(p.tensors, replace(p.cfg, **widths), qt,
                                   lt)
    np.testing.assert_array_equal(np.asarray(want_loci), loci.numpy())
    np.testing.assert_array_equal(np.asarray(want_ov), ov.numpy())
    if widths.get("frontier", 32) <= 2 and name == "usps":
        assert ov.numpy().any()        # the overflow path really ran


BEAM_CASES = [("paper", "ht", {}, 3),
              ("paper", "et", {"frontier": 2, "gens": 2, "expand": 2,
                               "max_steps": 3}, 3),
              ("paper", "tt", {}, 9),            # k above the emissions
              ("usps", "et", {}, 5),
              ("usps", "tt", {"gens": 4, "expand": 2, "frontier": 4}, 4),
              ("dblp", "et", {"gens": 3, "expand": 1, "frontier": 3,
                              "max_steps": 6}, 4)]


@pytest.mark.parametrize("name,kind,widths,k", BEAM_CASES)
def test_beam_topk_plain(indexes, name, kind, widths, k):
    j, p, qs = indexes[name, kind]
    qa, la, qt, lt = _queries(qs)
    jcfg, pcfg = replace(j.cfg, **widths), replace(p.cfg, **widths)
    # the port's loci (equal to the reference's, see test_locus_dp_plain)
    loci, _ = tref.locus_walk_ref(p.tensors, pcfg, qt, lt)
    want = _beam_ref(j.device, jcfg, jnp.asarray(loci.numpy()), k)
    got = tref.beam_topk_ref(p.tensors, pcfg, loci, k)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
    if widths.get("gens", 48) <= 3:
        assert not got[2].all()        # starved widths really went inexact


def test_wrappers_route_cpu_tensors_to_plain_versions(indexes):
    _, p, qs = indexes["usps", "tt"]
    _, _, qt, lt = _queries(qs)
    before = (trie_walk.launches, locus_dp.launches, beam_topk.launches,
              trie_walk.plain_calls)
    loci, ov = locus_dp.locus_dp_walk(p.tensors, p.cfg, qt, lt)
    want = locus_dp.locus_dp_plain(p.tensors, p.cfg, qt, lt)
    assert torch.equal(loci, want[0]) and torch.equal(ov, want[1])
    got = beam_topk.beam_topk_batch(p.tensors, p.cfg, loci, 5)
    want = beam_topk.beam_topk_plain(p.tensors, p.cfg, loci, 5)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    trie_walk.trie_walk(p.tensors.first_child, p.tensors.edge_char,
                        p.tensors.edge_child, qt, lt)
    after = (trie_walk.launches, locus_dp.launches, beam_topk.launches,
             trie_walk.plain_calls)
    assert after[:3] == before[:3]                # no kernel launched
    assert after[3] == before[3] + 1


@pytest.mark.parametrize("name", ["paper", "usps", "dblp"])
def test_cuda_substrate_rule_free_routing(indexes, name):
    """The cuda substrate's trie-walk route for rule-free tries lands on
    the same loci and overflow as the frontier DP."""
    _, p, qs = indexes[name, "plain"]
    _, _, qt, lt = _queries(qs + ["zzzz"])
    cuda = get_substrate("cuda")
    assert cuda._rule_free(p.tensors, p.cfg)
    got = cuda.walk_batch(p.tensors, p.cfg, qt, lt)
    want = get_substrate("torch").walk_batch(p.tensors, p.cfg, qt, lt)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
