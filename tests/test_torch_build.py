"""The port's host build and container loading against the JAX package.

The same corpora go through ``repro.api.build_index`` and
``repro_torch.build_index``; every host array, every static width and the
byte accounting must be equal.  A container saved by ``repro`` loads in the
port with every ``DeviceTrie`` field equal to ``repro``'s ``index.device``.
Everything is an integer, so equality is exact.
"""

import dataclasses

import numpy as np
import pytest

import repro_torch as rt
from repro.api import IndexSpec as JaxSpec
from repro.api import build_index as jax_build
from repro.core import make_rules
from repro.data.strings import make_dblp, make_usps
from repro_torch.core import trie_build as ptb
from repro_torch.core.engine.structs import DeviceTrie
from torch_threads import one_torch_thread  # noqa: F401

KINDS = ["plain", "tt", "et", "ht"]


def _corpus(name):
    if name == "paper":
        return (["andrew pavlo", "andrew parker", "andrew packard",
                 "william smith", "bill of rights"], [50, 40, 30, 20, 10],
                [("andy", "andrew"), ("bill", "william")])
    ds = make_usps(200, seed=0) if name == "usps" else make_dblp(150, seed=2)
    return ds.strings, ds.scores, ds.rules


def _pair(corpus, kind, **kw):
    strings, scores, rules = _corpus(corpus)
    rules = make_rules(rules) if kind != "plain" else []
    j = jax_build(strings, scores, rules,
                  JaxSpec(kind=kind, substrate="jnp", **kw))
    p = rt.build_index(strings, scores, rules, rt.IndexSpec(kind=kind, **kw),
                       device="cpu")
    return j, p


CASES = [(c, k) for c in ("paper", "usps", "dblp") for k in KINDS
         if not (c == "dblp" and k == "ht")]   # dblp's HT knapsack is slow


@pytest.mark.parametrize("corpus,kind", CASES)
def test_host_build_arrays_equal(corpus, kind):
    j, p = _pair(corpus, kind)
    for f in dataclasses.fields(ptb.DictTrie):
        a, b = getattr(j.trie, f.name), getattr(p.trie, f.name)
        if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name
    for f in dataclasses.fields(ptb.RuleTrie):
        a, b = getattr(j.rule_trie, f.name), getattr(p.rule_trie, f.name)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name
    assert p.strings == j.strings
    np.testing.assert_array_equal(p.scores, j.scores)


@pytest.mark.parametrize("corpus,kind", CASES)
def test_host_build_config_and_stats_equal(corpus, kind):
    j, p = _pair(corpus, kind)
    port_cfg = dataclasses.asdict(p.cfg)
    for name, value in dataclasses.asdict(j.cfg).items():
        if name in port_cfg and name != "substrate":
            assert port_cfg[name] == value, name
    assert p.cfg.substrate == "torch"     # auto on the CPU
    js, ps = dataclasses.asdict(j.stats), dataclasses.asdict(p.stats)
    js.pop("build_seconds"), ps.pop("build_seconds")
    assert ps == js


def _device_fields_equal(jax_dev, port_dev):
    for name in DeviceTrie._fields:
        if not hasattr(jax_dev, name):   # the port's own: c_ids's tree
            assert (port_dev.c_tree is None) == (port_dev.c_ids is None)
            continue
        if getattr(jax_dev, name) is None:     # a packed-only field
            assert getattr(port_dev, name) is None, name
            continue
        a = np.asarray(getattr(jax_dev, name))
        b = getattr(port_dev, name).cpu().numpy()
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("kind", KINDS)
def test_load_repro_container(tmp_path, kind):
    j, _ = _pair("usps", kind)
    path = str(tmp_path / f"{kind}.npz")
    j.save(path)
    p = rt.load_index(path, device="cpu")
    _device_fields_equal(j.device, p.tensors)
    assert p.kind == kind and p.strings == j.strings
    assert p.cfg.branch_width == j.cfg.branch_width
    assert (p.cfg.tele_width, p.cfg.term_width) == \
        (j.cfg.tele_width, j.cfg.term_width)
    assert (p.cfg.walk_tile, p.cfg.emit_tile, p.cfg.link_tile) == \
        (j.cfg.walk_tile, j.cfg.emit_tile, j.cfg.link_tile)


@pytest.mark.parametrize("kind", ["tt", "ht"])
def test_from_parts_carries_repro_build(kind):
    j, p = _pair("paper", kind)
    q = rt.CompletionIndex.from_parts(j.trie, j.rule_trie, j.rules,
                                      j.strings, j.scores, j.cfg,
                                      device="cpu")
    _device_fields_equal(j.device, q.tensors)
    assert q.cfg == p.cfg
    assert q.complete(["andy pa", "bil"], k=3) == \
        p.complete(["andy pa", "bil"], k=3)


def test_load_rejects_packed_container(tmp_path):
    """A packed container loads (tests/test_torch_packed.py); one whose
    side tables are inconsistent is rejected before it reaches the
    device."""
    strings, scores, rules = _corpus("paper")
    j = jax_build(strings, scores, make_rules(rules),
                  JaxSpec(kind="et", substrate="jnp", compression="packed"))
    path = str(tmp_path / "packed.npz")
    j.save(path)
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    arrays["trie__c_eptr"] = arrays["trie__c_eptr"][:-1]
    bad = str(tmp_path / "bad.npz")
    np.savez(bad, **arrays)
    with pytest.raises(ValueError, match="packed table"):
        rt.load_index(bad, device="cpu")
