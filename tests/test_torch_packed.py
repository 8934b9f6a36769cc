"""The compressed (packed, format v4) layout in the port against the JAX
package.

The same corpora go through ``repro`` (``substrate="jnp"``) and the port
on the CPU: the packed host arrays and their dtype tiers, the device
tensors, the plain packed locus walk and beam (against
``repro.kernels.ref`` on ``repro``'s packed index), ``complete`` end to
end (against ``repro``, the uncompressed port index and the oracle) and
containers saved by ``repro``.  Every output is an integer, so equality
is exact.  The CUDA kernels are held against these plain versions on the
card by ``chip_smoke.py``.
"""

import dataclasses
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
from repro.core.oracle import OracleIndex
from repro.data.strings import make_dblp, make_usps, make_workload
from repro.kernels import ref as jref
from repro_torch.core import trie_build as ptb
from repro_torch.core.alphabet import pad_queries
from repro_torch.core.engine import packed as pk
from repro_torch.core.engine.structs import DeviceTrie
from repro_torch.core.engine.substrate import complete_batch, get_substrate
from repro_torch.kernels import beam_topk, locus_dp, ref as tref
from torch_fast_jit import fast_jax_jit  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

KINDS = ["plain", "tt", "et", "ht"]
PAPER = (["andrew pavlo", "andrew parker", "andrew packard", "william smith",
          "bill of rights"], [50, 40, 30, 20, 10],
         [("andy", "andrew"), ("bill", "william")])
PAPER_QUERIES = ["andy pa", "andrew pa", "bil", "bill of", "a", "", "xyz",
                 "andy pavloz", "william smith", "w"]
RETRY = dict(frontier=64, gens=192, max_steps=2048)   # first retry round

# the references jitted once per (config, k); XLA's cheapest optimisation
# level keeps their compiles short (the integer results do not depend on it)
_FAST = {"xla_backend_optimization_level": 0}
_locus_ref = jax.jit(jref.locus_walk_ref, static_argnums=1,
                     compiler_options=_FAST)
_beam_ref = jax.jit(jref.beam_topk_ref, static_argnums=(1, 3),
                    compiler_options=_FAST)


def _corpus(name):
    if name == "paper":
        return PAPER
    ds = make_usps(300, seed=4) if name == "usps" else make_dblp(150, seed=2)
    return ds.strings, ds.scores, ds.rules


def _queries(name):
    if name == "paper":
        return PAPER_QUERIES
    ds = make_usps(300, seed=4) if name == "usps" else make_dblp(150, seed=2)
    return make_workload(ds, 11, seed=6) + ["", "qqq"]


def _rules(rules, kind):
    return make_rules(rules) if kind != "plain" else []


def _pair(corpus, kind, **kw):
    strings, scores, rules = _corpus(corpus)
    rules = _rules(rules, kind)
    j = jax_build(strings, scores, rules,
                  JaxSpec(kind=kind, substrate="jnp", **kw))
    p = rt.build_index(strings, scores, rules, rt.IndexSpec(kind=kind, **kw),
                       device="cpu")
    return j, p


def _device_fields_equal(jax_dev, port_dev):
    for name in DeviceTrie._fields:
        if not hasattr(jax_dev, name):   # the port's own: c_ids's tree
            assert (port_dev.c_tree is None) == (port_dev.c_ids is None)
            continue
        a, b = getattr(jax_dev, name), getattr(port_dev, name)
        if a is None:
            assert b is None, name
            continue
        a, b = np.asarray(a), b.cpu().numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


BUILD_CASES = [(c, k, ck) for c in ("paper", "usps", "dblp") for k in KINDS
               for ck in (0, 4) if not (c == "dblp" and k == "ht")]


@pytest.mark.parametrize("corpus,kind,cache_k", BUILD_CASES)
def test_pack_compressed_matches_repro(corpus, kind, cache_k):
    """Every host array of the packed build, its dtype tier, the engine
    config (table_widths included) and the byte accounting."""
    j, p = _pair(corpus, kind, compression="packed", cache_k=cache_k)
    assert p.trie.has_packed
    for f in dataclasses.fields(ptb.DictTrie):
        a, b = getattr(j.trie, f.name), getattr(p.trie, f.name)
        if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name
    port_cfg = dataclasses.asdict(p.cfg)
    for name, value in dataclasses.asdict(j.cfg).items():
        if name in port_cfg and name != "substrate":
            assert port_cfg[name] == value, name
    js, ps = dataclasses.asdict(j.stats), dataclasses.asdict(p.stats)
    js.pop("build_seconds"), ps.pop("build_seconds")
    assert ps == js
    _device_fields_equal(j.device, p.tensors)


def _packed_indexes(kind, corpus):
    j, p = _pair(corpus, kind, compression="packed")
    dense = rt.build_index(*_corpus(corpus)[:2],
                           _rules(_corpus(corpus)[2], kind),
                           rt.IndexSpec(kind=kind), device="cpu")
    qs = [q[:8] for q in _queries(corpus)]
    qa, la = pad_queries(qs, 8)
    return j, p, dense, qa, la


CORPUS_OF = {"plain": "usps", "tt": "paper", "et": "usps", "ht": "paper"}
# JAX compiles a reference per config (seconds each): the retry widths
# are held against it for ht (links and teleports), and against the dense
# port (itself held against JAX) for every kind
WALK_CASES = [(k, "default") for k in KINDS] + [("ht", "retry")]


def _walk_and_beam(kind, widths):
    j, p, dense, qa, la = _packed_indexes(kind, CORPUS_OF[kind])
    w = RETRY if widths == "retry" else {}
    jcfg, pcfg, dcfg = (replace(c, **w) for c in (j.cfg, p.cfg, dense.cfg))
    qt, lt = torch.from_numpy(qa), torch.from_numpy(la)
    loci, ov = tref.locus_walk_ref(p.tensors, pcfg, qt, lt)
    d_loci, d_ov = tref.locus_walk_ref(dense.tensors, dcfg, qt, lt)
    assert torch.equal(loci, d_loci) and torch.equal(ov, d_ov)
    assert (loci >= 0).any()
    got = tref.beam_topk_ref(p.tensors, pcfg, loci, 5)
    d_got = tref.beam_topk_ref(dense.tensors, dcfg, loci, 5)
    assert all(torch.equal(a, b) for a, b in zip(got, d_got))
    return j, jcfg, qa, la, (loci, ov), got


@pytest.mark.parametrize("kind,widths", WALK_CASES)
def test_packed_walk_and_beam_match_repro(kind, widths):
    """The plain packed locus walk and beam equal ``repro.kernels.ref`` on
    ``repro``'s packed index, and the port's dense layout bit for bit."""
    j, jcfg, qa, la, walk, beam = _walk_and_beam(kind, widths)
    want = _locus_ref(j.device, jcfg, jnp.asarray(qa), jnp.asarray(la))
    for a, b in zip(want, walk):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    want = _beam_ref(j.device, jcfg, jnp.asarray(walk[0].numpy()), 5)
    for a, b in zip(want, beam):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("kind", KINDS)
def test_packed_walk_and_beam_retry_widths_match_dense(kind):
    _walk_and_beam(kind, "retry")


def test_packed_beam_starved_matches_dense():
    """Starved widths make the packed beam inexact exactly where the dense
    one is."""
    _, p, dense, qa, la = _packed_indexes("et", "usps")
    starved = dict(frontier=3, gens=3, expand=1, max_steps=6)
    qt, lt = torch.from_numpy(qa), torch.from_numpy(la)
    pcfg, dcfg = replace(p.cfg, **starved), replace(dense.cfg, **starved)
    loci, _ = tref.locus_walk_ref(p.tensors, pcfg, qt, lt)
    got = tref.beam_topk_ref(p.tensors, pcfg, loci, 4)
    want = tref.beam_topk_ref(dense.tensors, dcfg, loci, 4)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert not got[2].all()


def _assert_matches_oracle(data, kind, queries, rows, k):
    strings, scores, rules = data
    oracle = OracleIndex(strings, scores, _rules(rules, kind))
    for q, row in zip(queries, rows):
        want = oracle.complete(q, k)
        assert [s for s, _ in row] == [s for s, _ in want], q
        matches = {x.decode() for x in oracle.matches(q)}
        assert {x for _, x in row} <= matches, q


@pytest.mark.parametrize("kind", KINDS)
def test_packed_complete_matches_dense_and_oracle(kind):
    """``complete`` on a packed index, with the widened retry forced by
    starved widths, equals the dense port index and the oracle; the cuda
    substrate's routing (answered by the plain versions here) agrees."""
    data = _corpus("usps")
    queries = _queries("usps")
    packed = rt.build_index(*data[:2], _rules(data[2], kind),
                            rt.IndexSpec(kind=kind, compression="packed"),
                            device="cpu")
    rows = packed.complete(queries, k=4)
    dense = rt.build_index(*data[:2], _rules(data[2], kind),
                           rt.IndexSpec(kind=kind), device="cpu")
    assert rows == dense.complete(queries, k=4)
    _assert_matches_oracle(data, kind, queries, rows, 4)
    starved = rt.build_index(*data[:2], _rules(data[2], kind),
                             rt.IndexSpec(kind=kind, compression="packed",
                                          frontier=2, gens=2, expand=2,
                                          max_steps=4), device="cpu")
    qs, ql = pad_queries(queries, 16)
    _, _, exact = complete_batch(starved.tensors, starved.cfg,
                                 torch.from_numpy(qs), torch.from_numpy(ql),
                                 4)
    assert not exact.all()                  # the retry really runs
    assert starved.complete(queries, k=4) == rows
    assert packed.reconfigure(substrate="cuda").complete(queries, k=4) == rows


def test_packed_complete_matches_repro():
    j, p = _pair("paper", "et", compression="packed")
    assert p.complete(PAPER_QUERIES, k=3) == j.complete(PAPER_QUERIES, k=3)


@pytest.mark.parametrize("kind", ["plain", "ht"])
def test_load_repro_packed_container(tmp_path, kind):
    """A format-4 packed container saved by ``repro`` loads into the port
    with every device tensor (dtype tiers included) equal and the same
    answers."""
    j, p = _pair("usps", kind, compression="packed")
    path = str(tmp_path / f"{kind}.npz")
    j.save(path)
    q = rt.load_index(path, device="cpu")
    assert q.trie.parent is None and q.trie.has_packed
    _device_fields_equal(j.device, q.tensors)
    assert q.cfg.table_widths == p.cfg.table_widths
    assert q.cfg.branch_width == j.cfg.branch_width
    queries = _queries("usps")
    assert q.complete(queries, k=4) == p.complete(queries, k=4)


def test_from_parts_carries_repro_packed_build():
    j, p = _pair("paper", "tt", compression="packed")
    q = rt.CompletionIndex.from_parts(j.trie, j.rule_trie, j.rules,
                                      j.strings, j.scores, j.cfg,
                                      device="cpu")
    _device_fields_equal(j.device, q.tensors)
    assert q.cfg == p.cfg and q.spec.compression == "packed"
    assert q.complete(PAPER_QUERIES, k=3) == p.complete(PAPER_QUERIES, k=3)


def test_packed_layout_validation_rejects_bad_tables():
    _, p = _pair("paper", "et", compression="packed")
    bad = dataclasses.replace(p.trie, c_eptr=p.trie.c_eptr[:-1])
    with pytest.raises(ValueError, match="pointer length"):
        rt.CompletionIndex.from_parts(bad, p.rule_trie, p.rules, p.strings,
                                      p.scores, p.cfg, device="cpu")
    cfg = dataclasses.replace(p.cfg, table_widths=())
    with pytest.raises(ValueError, match="table_widths"):
        rt.CompletionIndex.from_parts(p.trie, p.rule_trie, p.rules,
                                      p.strings, p.scores, cfg,
                                      device="cpu")


def test_cuda_substrate_packed_routing():
    """On a packed index the cuda substrate's walk is the locus DP (the
    dense CSR of the prefix walk is elided), for the plain kind too; the
    wrappers answer CPU tensors with their plain versions."""
    _, p, _, qa, la = _packed_indexes("plain", "usps")
    assert pk.is_packed(p.tensors) and p.tensors.first_child.numel() == 0
    qt, lt = torch.from_numpy(qa), torch.from_numpy(la)
    before = (locus_dp.packed_launches, beam_topk.packed_launches)
    got = get_substrate("cuda").walk_batch(p.tensors, p.cfg, qt, lt)
    want = get_substrate("torch").walk_batch(p.tensors, p.cfg, qt, lt)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    b = beam_topk.beam_topk_batch(p.tensors, p.cfg, got[0], 4)
    assert all(torch.equal(x, y) for x, y in zip(
        b, beam_topk.beam_topk_plain(p.tensors, p.cfg, got[0], 4)))
    assert (locus_dp.packed_launches, beam_topk.packed_launches) == before


def test_packed_empty_dictionary():
    idx = rt.build_index([], [], [], kind="et", compression="packed",
                         cache_k=2, device="cpu")
    assert idx.complete(["a", ""], k=3) == [[], []]
    assert idx.complete(["a"], k=1) == [[]]
