"""The cached phase 2's two kernels: launch plans, the packed rank tree,
and the plain versions against the JAX package on hard rows.

The CUDA kernels (``csrc/topk_select.cu``, ``csrc/locus_merge.cu``) run
only on the card (``chip_smoke.py``); here:

- the launch plans: keys a lane, warps a block and which path a width
  takes (the warp path up to 1,024 candidates, the block path past it);
- the static search tree over ``c_ids`` (``packed.rank_tree``): a numpy
  emulation of the kernel's exact loop (``tables.cuh`` ``tree_rank``)
  gives ``rep_rank`` (``torch.searchsorted``, clipped) at every node of a
  packed USPS ET index and on random sorted arrays; every packed index
  carries the tree;
- the wrappers' table check and its reuse, and their refusal of tensors
  no kernel takes (no fallback);
- ``topk_select`` and the cached merge (their plain versions, which the
  wrappers answer CPU tensors with) against ``repro.kernels.ref`` on rows
  of one score, unsorted rows over the whole int32 range, ``k = F*K`` and
  ``k > F*K``.  Every output is an integer, so equality is exact.
"""

import gc
from functools import lru_cache
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch as rt
from repro.core import make_rules
from repro.data.strings import make_usps
from repro.kernels import ref as jref
from repro_torch.core.engine import packed as pk
from repro_torch.kernels import _build, locus_merge, topk_select
from torch_fast_jit import fast_jax_jit  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

INT_MAX = 2**31 - 1


def _np_equal(a, b):
    np.testing.assert_array_equal(np.asarray(a), b.numpy())


# -- launch plans -------------------------------------------------------------

#: C -> (keys a lane, threads) at B=64 on 132 SMs: one warp a block
SELECT_PLANS = {1: (1, 32), 16: (1, 32), 17: (1, 32), 512: (16, 32),
                1024: (32, 32), 1025: (0, 256)}


@pytest.mark.parametrize("C", sorted(SELECT_PLANS))
def test_select_launch_plan(C):
    assert topk_select.launch_plan(C, 64, 132) == SELECT_PLANS[C]


@pytest.mark.parametrize("B,threads", [(1, 32), (132, 32), (133, 64),
                                       (1000, 256), (10**6, 256)])
def test_select_plan_spreads_a_batch_over_the_sms(B, threads):
    """The fewest warps a block that leave every SM at most one block,
    capped at eight."""
    keys, got = topk_select.launch_plan(512, B, 132)
    assert (keys, got) == (16, threads)
    assert -(-B // (got // 32)) <= 132 or got == 256


#: (F, K) -> the merge's (keys a lane, threads, shared bytes) at B=64:
#: the warp path keeps a warp's F rows and their score bases in shared
#: memory, the block path its C staged candidates and F rows
MERGE_PLANS = {(1, 1): (1, 32, 8), (1, 16): (1, 32, 8), (17, 1): (1, 32, 136),
               (32, 16): (16, 32, 256), (64, 16): (32, 32, 512),
               (1025, 1): (0, 256, 4 * (2 * 1025 + 1025))}


@pytest.mark.parametrize("F,K", sorted(MERGE_PLANS))
def test_merge_launch_plan(F, K):
    assert locus_merge.launch_plan(F, K, 64, 132) == MERGE_PLANS[F, K]


def test_merge_plan_raises_past_shared_memory():
    with pytest.raises(ValueError, match="shared memory"):
        locus_merge.launch_plan(2048, 16, 64, 132)


# -- the rank tree --------------------------------------------------------------


def tree_rank_np(tree, ids, nodes):
    """The kernel's ``tables::tree_rank`` loop, vectorized over nodes."""
    n = len(ids)
    if n == 0:
        return np.full(len(nodes), -1)
    levels, span = 0, 16
    while span < n:
        span <<= 4
        levels += 1
    p = np.zeros(len(nodes), np.int64)
    off = 0
    for m in range(levels, 0, -1):
        window = tree[off + 16 * p[:, None] + np.arange(16)]
        below = (window < nodes[:, None]).sum(axis=1)
        keys = (n + (1 << 4 * m) - 1) >> (4 * m)
        p = np.minimum(16 * p + below, keys - 1)
        off += ((n + (1 << 4 * (m + 1)) - 1) >> (4 * (m + 1))) << 4
    lo = 16 * p
    idx = lo[:, None] + np.arange(16)
    window = np.where(idx < n, ids[np.minimum(idx, n - 1)], INT_MAX)
    pos = lo + (window < nodes[:, None]).sum(axis=1)
    return np.where(pos < n, pos, n - 1)


def _rep_rank(ids, nodes):
    n = int(ids.shape[0])
    pos = torch.searchsorted(ids, nodes, side="left")
    return pos.clamp(max=n - 1).numpy()


@pytest.mark.parametrize("n", [0, 1, 16, 17, 255, 256, 257, 4096, 4097,
                               70_000])
def test_rank_tree_equals_rep_rank_on_sorted_arrays(n):
    rng = np.random.default_rng(n)
    ids = np.unique(rng.integers(0, 10 * n + 10, 2 * n))[:n].astype(np.int32)
    n = len(ids)
    ids_t = torch.from_numpy(ids)
    tree = pk.rank_tree(ids_t)
    assert tree.dtype == torch.int32 and len(tree) == pk.rank_tree_size(n)
    assert len(tree) % 16 == 0 and len(tree) <= n // 15 + 16 * 8
    nodes = np.concatenate([ids, ids - 1, ids + 1, [0, INT_MAX - 1],
                            rng.integers(0, 10 * n + 20, 500)])
    nodes = nodes.astype(np.int32)
    got = tree_rank_np(tree.numpy(), ids, nodes)
    want = (_rep_rank(ids_t, torch.from_numpy(nodes)) if n
            else np.full(len(nodes), -1))
    np.testing.assert_array_equal(got, want)


@lru_cache(maxsize=1)
def _usps_packed():
    ds = make_usps(3000, seed=2)
    return rt.build_index(ds.strings, ds.scores, make_rules(ds.rules),
                          kind="et", cache_k=4, compression="packed",
                          device="cpu")


def test_rank_tree_equals_rep_rank_at_every_node_of_an_index():
    idx = _usps_packed()
    t = idx.tensors
    nodes = torch.arange(int(t.p_labels.shape[0]), dtype=torch.int32)
    assert int(t.c_ids.shape[0]) > 256          # two levels and the ids
    got = tree_rank_np(t.c_tree.numpy(), t.c_ids.numpy(), nodes.numpy())
    np.testing.assert_array_equal(got, _rep_rank(t.c_ids, nodes))
    np.testing.assert_array_equal(got, pk._rank(t.c_ids, nodes.long())[0])


def test_every_packed_index_carries_the_tree():
    idx = _usps_packed()
    assert torch.equal(idx.tensors.c_tree, pk.rank_tree(idx.tensors.c_ids))
    again = rt.CompletionIndex.from_parts(
        idx.trie, idx.rule_trie, idx.rules, idx.strings, idx.scores,
        idx.cfg, device="cpu", spec=idx.spec)
    assert torch.equal(again.tensors.c_tree, idx.tensors.c_tree)
    dense = rt.build_index(["abc", "abd"], [3, 2], [], device="cpu")
    assert dense.tensors.c_tree is None


# -- the wrappers' table check -------------------------------------------------------


def test_merge_tables_are_checked_once_and_never_outlive_them(monkeypatch):
    """The checked argument prefix is reused while the index's very same
    table tensors are in use, rebuilt when one changes, and dropped when
    the score table is freed."""
    monkeypatch.setattr(_build, "check_tensors", lambda *a, **kw: None)
    score = torch.zeros((5, 4), dtype=torch.int32)
    sid = torch.zeros((5, 4), dtype=torch.int32)
    t = SimpleNamespace(pc_score=None, topk_score=score, topk_sid=sid,
                        p_labels=None, depth=torch.zeros(5))
    first = locus_merge._tables(t)
    assert locus_merge._tables(t) is first
    assert first[1].score == score.data_ptr() and first[1].K == 4
    t.topk_sid = sid.clone()
    second = locus_merge._tables(t)
    assert second is not first and second[1].sid == t.topk_sid.data_ptr()
    key = id(score)
    assert key in locus_merge._checked
    del t, score, first, second
    gc.collect()
    assert key not in locus_merge._checked


def test_merge_refuses_an_index_without_a_cache(monkeypatch):
    monkeypatch.setattr(_build, "check_tensors", lambda *a, **kw: None)
    idx = rt.build_index(["abc", "abd"], [3, 2], [], device="cpu")
    with pytest.raises(ValueError, match="no top-K cache"):
        locus_merge._tables(idx.tensors)


def test_wrappers_raise_on_tensors_no_kernel_takes():
    """Off the CPU there is no plain version to fall back to: tensors the
    kernel cannot take raise."""
    idx = rt.build_index(["abc", "abd"], [3, 2], [], cache_k=2,
                         device="cpu")
    loci = torch.empty((4, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        locus_merge.locus_topk_merge(idx.tensors, loci, 2)
    rows = torch.empty((4, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        topk_select.topk_select(rows, rows, 2)


# -- the plain versions against the JAX package on hard rows ---------------------------

ROWS = ("one score", "unsorted")


def _rows(kind, shape, rng):
    if kind == "one score":
        return np.full(shape, 7, np.int32)
    return rng.integers(-2**31, 2**31 - 1, shape, dtype=np.int64).astype(
        np.int32)


@pytest.mark.parametrize("kind", ROWS)
@pytest.mark.parametrize("C,k", [(1, 1), (17, 17), (100, 10), (1025, 1025)])
def test_topk_select_matches_repro_on_hard_rows(kind, C, k):
    rng = np.random.default_rng(C + k)
    scores = _rows(kind, (6, C), rng)
    payload = rng.integers(-1, 10**6, (6, C)).astype(np.int32)
    want = jref.topk_select_ref(jnp.asarray(scores), jnp.asarray(payload), k)
    got = topk_select.topk_select(torch.from_numpy(scores),
                                  torch.from_numpy(payload), k)
    for a, b in zip(want, got):
        _np_equal(a, b)


@pytest.mark.parametrize("kind", ROWS)
@pytest.mark.parametrize("F,K,k", [(32, 16, 512), (32, 16, 600), (3, 4, 12),
                                   (5, 4, 27)])
def test_cached_merge_matches_repro_on_hard_rows(kind, F, K, k):
    """Cache rows of one score, or unsorted over the whole int32 range
    (the kernel assumes no row order); ``k = F*K`` sorts the union and
    ``k > F*K`` pads it with -1."""
    rng = np.random.default_rng(F * K + k)
    n = 50
    score = _rows(kind, (n, K), rng)
    sid = rng.integers(-1, 10**5, (n, K)).astype(np.int32)
    loci = rng.integers(-1, n, (6, F)).astype(np.int32)
    width = min(k, F * K)
    want = jref.cached_topk_merge_ref(jnp.asarray(loci), jnp.asarray(score),
                                      jnp.asarray(sid), width)
    t = SimpleNamespace(p_labels=None, topk_score=torch.from_numpy(score),
                        topk_sid=torch.from_numpy(sid))
    got = locus_merge.locus_topk_merge(t, torch.from_numpy(loci), k)
    for a, b in zip(want, got):
        _np_equal(a, b[:, :width])
        assert (b[:, width:] == -1).all()
