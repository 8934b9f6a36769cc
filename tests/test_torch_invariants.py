"""What the locus-DP and beam kernels' designs rely on, pinned on the CPU
against the JAX package.

- A row past a query's last character holds no state and its merges add
  no overflow, so the kernel's sweep ends there: the plain locus DP on
  the same queries padded to L = 32 and to the longest query gives equal
  loci and equal overflow counts, at E = 0, 1 and 2, dense and packed,
  and both equal ``repro.kernels.ref.locus_walk_ref`` (jnp).
- The beam's pool order decides which generator is popped on a tie: on
  tie-heavy corpora (every score equal; scores drawn from a set of 3) the
  port's beam gives ``repro``'s (jnp) scores, string ids and ``exact``
  flags at the default widths and the first retry round's.

Queries are prefixes of dictionary strings, a third with one character
replaced, cut and chosen by a numpy generator; every output is an integer,
so equality is exact.
"""

from dataclasses import replace
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch as rt
from repro.api import IndexSpec as JaxSpec
from repro.api import build_index as jax_build
from repro.core import make_rules
from repro.data.strings import make_usps
from repro.kernels import ref as jref
from repro_torch.core.alphabet import pad_queries
from repro_torch.kernels import beam_topk, locus_dp
from torch_fast_jit import fast_jax_jit  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

_FAST = {"xla_backend_optimization_level": 0}
_locus_ref = jax.jit(jref.locus_walk_ref, static_argnums=1,
                     compiler_options=_FAST)
_beam_ref = jax.jit(jref.beam_topk_ref, static_argnums=(1, 3),
                    compiler_options=_FAST)

N_STRINGS = 2000
RETRY = dict(frontier=64, gens=192, max_steps=1024)   # the first round's


def _queries(strings, n, seed):
    """n prefixes of seeded strings (lengths 1-24), every third with one
    character replaced; one query is a single character."""
    rng = np.random.default_rng(seed)
    out = []
    for i in rng.choice(len(strings), n, replace=False):
        s = bytearray(strings[i].encode()[:int(rng.integers(1, 25))])
        if len(out) % 3 == 2:
            s[int(rng.integers(len(s)))] = int(rng.integers(97, 123))
        out.append(bytes(s))
    out[0] = out[0][:1]
    return out


@lru_cache(maxsize=1)
def _usps():
    return make_usps(N_STRINGS, seed=4)


@lru_cache(maxsize=6)
def _indexes(scores_name, e):
    """(repro jnp index, {layout: port index}) on the USPS cut, ET, with
    the corpus's scores or a tie-heavy set."""
    ds = _usps()
    scores = {"corpus": ds.scores,
              "equal": [7] * len(ds.strings),
              "three": np.random.default_rng(5).choice(
                  [5, 9, 13], len(ds.strings)).tolist()}[scores_name]
    rules = make_rules(ds.rules)
    j = jax_build(ds.strings, scores, rules,
                  JaxSpec(kind="et", substrate="jnp", edit_budget=e))
    ports = {c: rt.build_index(ds.strings, scores, rules,
                               rt.IndexSpec(kind="et", edit_budget=e,
                                            compression=c), device="cpu")
             for c in ("none", "packed")}
    return j, ports


@lru_cache(maxsize=3)
def _locus_want(e):
    j, _ = _indexes("corpus", e)
    qs = _queries(_usps().strings, 24, seed=e)
    longest = max(len(q) for q in qs)
    qa, la = pad_queries(qs, longest)
    want = _locus_ref(j.device, j.cfg, jnp.asarray(qa), jnp.asarray(la))
    return qs, longest, [np.asarray(w) for w in want]


@pytest.mark.parametrize("compression", ["none", "packed"])
@pytest.mark.parametrize("e", [0, 1, 2])
def test_locus_rows_past_the_last_character_add_nothing(e, compression):
    qs, longest, want = _locus_want(e)
    p = _indexes("corpus", e)[1][compression]
    assert longest < 32
    got = {}
    for width in (32, longest):
        qa, la = pad_queries(qs, width)
        got[width] = locus_dp.locus_dp_plain(
            p.tensors, p.cfg, torch.from_numpy(qa), torch.from_numpy(la))
    for a, b in zip(got[32], got[longest]):
        assert torch.equal(a, b)
    for w, g in zip(want, got[32]):
        np.testing.assert_array_equal(w, g.numpy())
    if e == 2:
        assert (got[32][1] > 0).any()   # the overflow counts are exercised


@pytest.mark.parametrize("widths", ["default", "retry"])
@pytest.mark.parametrize("scores", ["equal", "three"])
def test_beam_tie_heavy_matches_repro(scores, widths):
    j, ports = _indexes(scores, 0)
    qs = _queries(_usps().strings, 16, seed=7) + [b"", b"zzzz"]
    qa, la = pad_queries(qs, 32)
    extra = RETRY if widths == "retry" else {}
    jcfg = replace(j.cfg, **extra)
    loci = _locus_ref(j.device, jcfg, jnp.asarray(qa), jnp.asarray(la))[0]
    want = [np.asarray(w) for w in _beam_ref(j.device, jcfg, loci, 10)]
    for compression, p in ports.items():
        got = beam_topk.beam_topk_batch(
            p.tensors, replace(p.cfg, **extra),
            torch.from_numpy(np.array(loci)), 10)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(w, g.numpy(), err_msg=compression)
    if scores == "equal":
        assert set(want[0][want[0] >= 0].tolist()) == {7}
