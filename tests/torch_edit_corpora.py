"""The corpora and indexes the bounded-edit tests share
(``test_torch_edits.py``, ``test_torch_edit_locus.py``): 2,000-string cuts
of USPS and DBLP with 13 queries each, and each package's index over one,
built once a module (``built_once_a_module``: a test module opts in with
``from torch_edit_corpora import built_once_a_module  # noqa: F401``)."""

from dataclasses import replace
from functools import lru_cache

import pytest

import repro_torch as rt
from repro.api import IndexSpec as JaxSpec
from repro.api import build_index as jax_build
from repro.core import make_rules
from repro.data.strings import make_dblp, make_usps, make_workload

KINDS = ["plain", "tt", "et", "ht"]
# DBLP's hybrid build runs its rule knapsack for ~30 s: ht takes USPS
CORPUS_OF = {"plain": "usps", "tt": "dblp", "et": "usps", "ht": "usps"}


def rules_of(rules, kind):
    return make_rules(rules) if kind != "plain" else []


@lru_cache(maxsize=2)
def corpus(name):
    """A 2,000-string cut of USPS or DBLP and 13 of its queries."""
    ds = make_usps(2000, seed=4) if name == "usps" else make_dblp(2000, seed=2)
    queries = make_workload(ds, 11, seed=6) + ["", "qqq"]
    return (ds.strings, ds.scores, ds.rules), queries


def port_index(data, kind, **kw):
    strings, scores, rules = data
    return rt.build_index(strings, scores, rules_of(rules, kind),
                          rt.IndexSpec(kind=kind, **kw), device="cpu")


def jax_index(data, kind, **kw):
    strings, scores, rules = data
    return jax_build(strings, scores, rules_of(rules, kind),
                     JaxSpec(kind=kind, substrate="jnp", **kw))


@lru_cache(maxsize=None)
def built(pkg, name, kind, edit_budget=0, **kw):
    """(config, index): the corpus index of ``pkg`` ("port" or "jax"),
    built once a module at edit budget 0, and its config at
    ``edit_budget`` (a runtime field of both packages' engine configs: no
    rebuild).  Callers read the index and pass the config; none mutates
    it."""
    data, _ = corpus(name)
    idx = (port_index if pkg == "port" else jax_index)(data, kind, **kw)
    return replace(idx.cfg, edit_budget=edit_budget), idx


@pytest.fixture(scope="module", autouse=True)
def built_once_a_module():
    yield
    built.cache_clear()
