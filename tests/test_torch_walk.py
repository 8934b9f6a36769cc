"""The prefix walk (``kernels/trie_walk.py``): its two entries, the step
of the warp kernel, its launch plan and its table check.

The CUDA kernel (``csrc/trie_walk.cu``) runs only on the card
(``chip_smoke.py``); here:

- the loci entry's plain version (which the wrapper answers CPU tensors
  with) against the JAX package's rule-free pallas route (the Pallas
  ``trie_walk`` in interpret mode, then its loci epilogue) and against the
  port's ``"torch"`` substrate, on tries whose rows are of 1, of 16 and
  wider than 32, and on an empty edge table; B not a multiple of a block,
  ``qlen`` < L, -1 padding inside and after ``qlen``;
- a numpy emulation of the kernel's step (a lane an edge, 32 edges a
  round, a ballot of ``char >= c``) against the lower bound
  (``np.searchsorted``) on sorted rows of unique characters of width
  0-256;
- the launch plan, the table check and its reuse, and the refusal of
  tensors no kernel takes.

Every output is an integer, so equality is exact.
"""

import gc

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch as rt
from repro.core import CompletionIndex, make_rules
from repro.core.alphabet import pad_queries
from repro.core.engine.substrate import get_substrate as jax_substrate
from repro_torch.core.engine.substrate import get_substrate
from repro_torch.kernels import _build, trie_walk as tw
from torch_fast_jit import fast_jax_jit  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

INT_MAX = 2**31 - 1


def _corpus(name):
    """Strings whose trie has rows of 1 (chains), of 16, and wider than 32
    (random bytes 1-255: a root row of 255, second rows of ~100); or
    none."""
    rng = np.random.default_rng(3)
    if name == "rows of 1":
        return [b"abcdefghijklmnopqrstuvwxyz", b"zyxwvutsrqponmlk", b"q"]
    if name == "rows of 16":
        letters = b"abcdefghijklmnop"
        return [bytes([a, b, c]) for a in letters for b in letters
                for c in letters[:2]]
    if name == "wide rows":
        out = [bytes([i]) + rng.integers(1, 256, rng.integers(0, 5))
               .astype(np.uint8).tobytes() for i in range(1, 256)]
        return out + [bytes([int(rng.choice([97, 200]))])
                      + rng.integers(1, 256, rng.integers(1, 7))
                      .astype(np.uint8).tobytes() for _ in range(300)]
    return []


def _queries(strings, n, L, seed):
    """n queries of up to L bytes: prefixes, whole strings typed on past
    their end, a random last byte, one byte, the empty query; some rows'
    qlen runs past their characters (-1 inside qlen)."""
    rng = np.random.default_rng(seed)
    pool = strings or [b"abc"]
    qs = []
    for i in range(n):
        s = pool[int(rng.integers(0, len(pool)))]
        kind = i % 5
        if kind == 0:
            qs.append(s[:int(rng.integers(1, len(s) + 1))])
        elif kind == 1:
            qs.append(b" ".join([s] * 4)[:L])
        elif kind == 2:
            qs.append(s[:int(rng.integers(0, len(s)))]
                      + bytes([int(rng.integers(1, 256))]))
        elif kind == 3:
            qs.append(s[:1])
        else:
            qs.append(b"" if i % 10 == 4 else s)
    q, ql = pad_queries(qs, L)
    ql[6::7] = np.minimum(ql[6::7] + 2, L)
    return q, ql


CORPORA = ("rows of 1", "rows of 16", "wide rows", "empty")


@pytest.fixture(scope="module")
def indexes():
    """Per corpus: the JAX package's plain index and the port's, built
    from the same strings (node ids agree)."""
    out = {}
    for name in CORPORA:
        s = _corpus(name)
        scores = list(range(len(s)))
        out[name] = (CompletionIndex.build(s, scores, make_rules([]),
                                           kind="plain"),
                     rt.build_index(s, scores, [], kind="plain",
                                    device="cpu"))
    return out


def test_corpora_have_the_rows_they_are_named_for(indexes):
    widths = {}
    for name in CORPORA:
        fc = indexes[name][1].tensors.first_child
        w = (fc[1:] - fc[:-1]).numpy()
        widths[name] = (int(w[0]) if len(w) else 0, int(w.max(initial=0)))
    assert widths["rows of 1"] == (3, 3)
    assert widths["rows of 16"] == (16, 16)
    assert widths["wide rows"] == (255, 255)
    t = indexes["wide rows"][1].tensors
    for byte in (97, 200):       # second rows read in several rounds
        node = int(t.edge_child[int(t.first_child[0]) + byte - 1])
        assert int(t.first_child[node + 1] - t.first_child[node]) > 32
    assert widths["empty"] == (0, 0)


@pytest.mark.parametrize("name,B,L", [
    ("rows of 1", 37, 16), ("rows of 16", 37, 16), ("wide rows", 37, 16),
    ("wide rows", 5, 8), ("empty", 37, 16)])
def test_loci_entry_matches_repro_and_the_torch_substrate(indexes, name, B,
                                                          L):
    j, p = indexes[name]
    q, ql = _queries(_corpus(name), B, L, seed=B + L)
    assert (ql < L).any() and (q == -1).any()
    want = jax_substrate("pallas").walk_batch(j.device, j.cfg,
                                              jnp.asarray(q), jnp.asarray(ql))
    qt, lt = torch.from_numpy(q), torch.from_numpy(ql)
    before = (tw.launches, tw.plain_calls)
    got = tw.trie_walk_loci(p.tensors.first_child, p.tensors.edge_char,
                            p.tensors.edge_child, qt, lt, p.cfg.frontier)
    assert (tw.launches, tw.plain_calls) == (before[0], before[1] + 1)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
    torch_sub = get_substrate("torch").walk_batch(p.tensors, p.cfg, qt, lt)
    cuda_sub = get_substrate("cuda").walk_batch(p.tensors, p.cfg, qt, lt)
    for a, b, c in zip(got, torch_sub, cuda_sub):
        assert torch.equal(a, b) and torch.equal(a, c)
    # the (node, depth) entry is the loci entry's walk
    node, depth = tw.trie_walk(p.tensors.first_child, p.tensors.edge_char,
                               p.tensors.edge_child, qt, lt)
    assert torch.equal(got[0][:, 0], torch.where(depth == lt, node, -1))
    if name != "empty":
        assert (got[0][:, 0] >= 0).any() and (got[0][:, 0] < 0).any()


# -- the kernel's step ----------------------------------------------------------


def _ballot_step(chars, lo, hi, c):
    """The kernel's step, lane for lane: (lower-bound index, child found)
    for character c in the row [lo, hi) of ``chars``."""
    lanes = np.arange(32)
    e0 = lo
    while True:
        e = e0 + lanes
        inside = e < hi
        ec = np.where(inside, chars[np.minimum(e, len(chars) - 1)], INT_MAX)
        ge = ec >= c
        if ge.any():
            lane = int(np.argmax(ge))       # __ffs(ballot) - 1
            return e0 + lane, bool(ec[lane] == c)
        e0 += 32


@pytest.mark.parametrize("width", [0, 1, 2, 16, 31, 32, 33, 63, 64, 65, 100,
                                   200, 255, 256])
def test_ballot_step_is_the_lower_bound(width):
    rng = np.random.default_rng(width)
    row = np.sort(rng.choice(256, width, replace=False)).astype(np.int64)
    pad = int(rng.integers(0, 40))
    chars = np.concatenate([rng.integers(0, 256, pad), row,
                            rng.integers(0, 256, 7)])
    lo, hi = pad, pad + width
    absent = sorted(set(range(256)) - set(row.tolist()))
    cs = set(rng.choice(absent, min(8, len(absent)), replace=False).tolist())
    cs |= {0, 255}
    if width:
        cs |= {int(row[0]), int(row[-1]), int(row[width // 2])}
        cs |= {int(row[0]) - 1, int(row[-1]) + 1} - {-1, 256}
    for c in sorted(cs):
        pos, found = _ballot_step(chars, lo, hi, c)
        want = lo + int(np.searchsorted(row, c, side="left"))
        assert pos == want, (width, c)
        assert found == (c in set(row.tolist())), (width, c)


# -- the launch plan and the table check ------------------------------------------


@pytest.mark.parametrize("B,sms,plan", [
    (1, 132, (32, 1)), (64, 132, (32, 64)), (65, 132, (32, 65)),
    (64, 64, (32, 64)), (65, 64, (64, 33)), (1024, 132, (256, 128)),
    (10**6, 132, (256, 125000))])
def test_launch_plan_spreads_a_batch_over_the_sms(B, sms, plan):
    """A warp a query; the fewest warps a block (at most eight) that give
    every SM at most one block."""
    assert tw.launch_plan(B, sms) == plan


def _csr():
    return (torch.tensor([0, 2, 2, 2], dtype=torch.int32),
            torch.tensor([97, 98], dtype=torch.int32),
            torch.tensor([1, 2], dtype=torch.int32))


def test_tables_are_checked_once_and_never_outlive_them(monkeypatch):
    """The checked ``_Trie`` is reused while the very same tensors are
    passed, rebuilt when an edge table changes, and dropped when
    ``first_child`` is freed."""
    monkeypatch.setattr(_build, "check_tensors", lambda *a, **kw: None)
    fc, ec, ek = _csr()
    first = tw._tables(fc, ec, ek)
    assert tw._tables(fc, ec, ek) is first
    assert first[1].first_child == fc.data_ptr() and first[1].n_edges == 2
    ek2 = ek.clone()
    second = tw._tables(fc, ec, ek2)
    assert second is not first and second[1].edge_child == ek2.data_ptr()
    key = id(fc)
    assert key in tw._checked
    del fc, first, second
    gc.collect()
    assert key not in tw._checked


@pytest.mark.parametrize("fault", ["lengths", "dtype", "no root pair"])
def test_tables_refuse_a_malformed_csr(monkeypatch, fault):
    monkeypatch.setattr(_build, "check_tensors", lambda *a, **kw: None)
    fc, ec, ek = _csr()
    if fault == "lengths":
        ek = ek[:1]
    elif fault == "dtype":
        ec = ec.long()
    else:
        fc = fc[:1]
    with pytest.raises((ValueError, TypeError)):
        tw._tables(fc, ec, ek)


def test_wrappers_raise_on_tensors_no_kernel_takes():
    """Off the CPU there is no plain version to fall back to."""
    fc, ec, ek = _csr()
    q = torch.empty((4, 8), dtype=torch.int32, device="meta")
    ql = torch.empty((4,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tw.trie_walk(fc, ec, ek, q, ql)
    with pytest.raises(ValueError, match="no kernel"):
        tw.trie_walk_loci(fc, ec, ek, q, ql, 8)
    with pytest.raises(ValueError, match="frontier"):
        tw.trie_walk_loci(fc, ec, ek, torch.zeros((4, 8), dtype=torch.int32),
                          torch.zeros(4, dtype=torch.int32), 0)
