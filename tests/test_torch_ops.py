"""The off-path kernels' entry points in the port against the JAX package:
``ops.candidate_topk`` (fused dot scoring + top-k, float32 or bfloat16)
and ``ops.embedding_bag`` (ragged gather + sum or mean).

On the CPU the port's wrappers answer with their plain versions; the same
numpy inputs go through the Pallas kernels (interpret mode) and
``repro.kernels.ref``.  The CUDA kernels are held against these plain
versions on the card by ``chip_smoke.py``; what the CPU can check of them
is their launch arithmetic: ``candidate_topk``'s launch plan, and that
the ragged ``embedding_bag`` entry's arguments describe the batch that
``densify_bags`` builds for the plain version.

Tolerances: scores are float32 dot products summed in another order than
XLA's, so they agree to float32 rounding (rtol 1e-5, as
``tests/test_kernels.py``); ids are compared exactly on seeded normal data,
where no two of the top scores lie that close.  EmbeddingBag sums are
float32 (1e-5); bfloat16 tables round the products and the result to
bfloat16 in the JAX package and only the result in the port (3e-2, as
``tests/test_kernels.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.candidate_topk import candidate_topk as pallas_topk
from repro_torch.kernels import candidate_topk as ct
from repro_torch.kernels import embedding_bag as eb
from repro_torch.kernels import ops, ref
from torch_threads import one_torch_thread  # noqa: F401

NEG_FILL = np.float32(-3.0e38)


def _inputs(C, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=D).astype(np.float32),
            rng.normal(size=(C, D)).astype(np.float32))


# -- candidate_topk -------------------------------------------------------------


@pytest.mark.parametrize("C,D,k,block_c", [
    (256, 32, 5, 64), (1024, 64, 10, 256), (512, 8, 40, 512)])
def test_candidate_topk_matches_pallas(C, D, k, block_c):
    """C divides by block_c: the Pallas kernel's running top-k is right
    there, and the port agrees with it."""
    q, c = _inputs(C, D, C + k)
    want = pallas_topk(jnp.asarray(q), jnp.asarray(c), k, block_c=block_c,
                       interpret=True)
    got = ops.candidate_topk(torch.from_numpy(q), torch.from_numpy(c), k,
                             block_c=block_c)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-5)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32


@pytest.mark.parametrize("C,D,k,block_c", [
    (300, 8, 200, 256),   # the JAX wrapper's zero-row padding shows here
    (1000, 16, 10, 96), (37, 5, 37, 1024), (5000, 64, 100, 1024)])
def test_candidate_topk_ragged_matches_ref(C, D, k, block_c):
    """Ragged C follows ``repro.kernels.ref.candidate_topk_ref``'s order:
    no padded row takes a real candidate's place."""
    q, c = _inputs(C, D, C + k)
    want = jref.candidate_topk_ref(jnp.asarray(q), jnp.asarray(c), k)
    got = ops.candidate_topk(torch.from_numpy(q), torch.from_numpy(c), k,
                             block_c=block_c)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-5)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert (got[1] >= 0).all()


def test_candidate_topk_jax_wrapper_loses_candidates_on_ragged_c():
    """The reference fault the port does not copy: ``repro``'s
    ``ops.candidate_topk`` pads C to a multiple of block_c with zero rows
    and masks them only after the top-k, so on negative scores padded rows
    push real candidates out (ROADMAP §3)."""
    q, c = _inputs(300, 8, 0)
    jax_ids = np.asarray(jops.candidate_topk(jnp.asarray(q), jnp.asarray(c),
                                             200, block_c=256)[1])
    assert (jax_ids == -1).any()
    got = ops.candidate_topk(torch.from_numpy(q), torch.from_numpy(c), 200,
                             block_c=256)[1].numpy()
    want = np.asarray(jref.candidate_topk_ref(jnp.asarray(q), jnp.asarray(c),
                                              200)[1])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("C,k", [(5, 9), (1, 3)])
def test_candidate_topk_k_above_c(C, k):
    """Slots past C hold (-3.0e38, -1), the Pallas kernel's init."""
    q, c = _inputs(C, 4, 7)
    got = ops.candidate_topk(torch.from_numpy(q), torch.from_numpy(c), k)
    want = jref.candidate_topk_ref(jnp.asarray(q), jnp.asarray(c), C)
    np.testing.assert_allclose(got[0][:C].numpy(), np.asarray(want[0]),
                               rtol=1e-5)
    np.testing.assert_array_equal(got[1][:C].numpy(), np.asarray(want[1]))
    assert (got[0][C:] == NEG_FILL).all() and (got[1][C:] == -1).all()
    single = pallas_topk(jnp.asarray(q), jnp.asarray(c), k, block_c=C,
                         interpret=True)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(single[1]))


def test_candidate_topk_ties_go_to_the_lower_id():
    q = torch.ones(4)
    c = torch.zeros((50, 4))
    c[[7, 30, 41]] = 1.0
    s, i = ref.candidate_topk_ref(q, c, 6)
    assert i.tolist() == [7, 30, 41, 0, 1, 2]
    assert s.tolist() == [4.0, 4.0, 4.0, 0.0, 0.0, 0.0]


@pytest.mark.parametrize("C,D,k,block_c", [(1024, 64, 10, 256),
                                           (512, 16, 40, 512)])
def test_candidate_topk_bfloat16_matches_repro(C, D, k, block_c):
    """bfloat16 query and candidates are widened to float32, as the Pallas
    kernel widens them: the port answers as ``repro``'s ``ops``."""
    q, c = _inputs(C, D, C + D)
    want = jops.candidate_topk(jnp.asarray(q, jnp.bfloat16),
                               jnp.asarray(c, jnp.bfloat16), k,
                               block_c=block_c)
    got = ops.candidate_topk(torch.from_numpy(q).bfloat16(),
                             torch.from_numpy(c).bfloat16(), k,
                             block_c=block_c)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-5)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[0].dtype == torch.float32


@pytest.mark.parametrize("case", ["equal", "ascending"])
def test_candidate_topk_tie_and_ascending_inputs(case):
    """Integer-valued inputs, so every summation order gives the same
    scores: all rows equal (the ids are 0..k-1), and scores ascending by id
    (every row beats the running k-th best)."""
    C, D, k = 3000, 16, 100
    rng = np.random.default_rng(5)
    if case == "equal":
        q = rng.integers(-3, 4, D).astype(np.float32)
        c = np.tile(rng.integers(-3, 4, D), (C, 1)).astype(np.float32)
    else:
        q = np.eye(D, dtype=np.float32)[0]
        c = rng.integers(-3, 4, (C, D)).astype(np.float32)
        c[:, 0] = np.arange(C)
    want = jref.candidate_topk_ref(jnp.asarray(q), jnp.asarray(c), k)
    got = ops.candidate_topk(torch.from_numpy(q), torch.from_numpy(c), k,
                             block_c=256)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    ids = np.arange(k) if case == "equal" else np.arange(C - 1, C - 1 - k, -1)
    np.testing.assert_array_equal(got[1].numpy(), ids)


def test_candidate_topk_launch_plan(monkeypatch):
    """Two blocks per SM over contiguous slices of at least ``block_c``
    rows; 16 lanes per float32 row of 64 (8 for bfloat16, a warp per row
    on the scalar path); buffers of k keys plus a round; past the largest
    k a buffer would pass a block's 227 KB and the plan raises."""
    p = ct.launch_plan(1_000_000, 64, 100, 1024)
    assert p == ct.Plan(n_blocks=264, rows_per_block=3788, lanes_per_row=16,
                        rows_per_round=128, cap=1024, merge_cap=2048)
    bf16 = ct.launch_plan(1_000_000, 64, 100, elem_bytes=2)
    assert (bf16.lanes_per_row, bf16.rows_per_round) == (8, 256)
    scalar = ct.launch_plan(1_000_000, 33, 100, vec=False)
    assert (scalar.lanes_per_row, scalar.rows_per_round) == (32, 64)
    assert ct.launch_plan(300, 8, 200, 256)[:2] == (2, 150)
    assert ct.launch_plan(4097, 64, 1, 64).n_blocks == 65
    assert ct.launch_plan(5, 64, 9).n_blocks == 1
    assert ct.launch_plan(10**6, 64, 100, n_sms=4).n_blocks == 8
    top = ct.max_k(64)
    assert top == 16384 - ct.MERGE_THREADS
    big = ct.launch_plan(10**6, 64, top)
    assert big.cap >= top + big.rows_per_round
    assert big.merge_cap >= top + ct.MERGE_THREADS
    assert 8 * max(big.cap, big.merge_cap) <= 232_448
    with pytest.raises(ValueError, match="shared memory"):
        ct.launch_plan(10**6, 64, top + 1)
    assert ct.max_k(4) == 16384 - 2048      # 32 rows a warp load
    monkeypatch.setattr(ct._build, "MAX_SHARED_BYTES", 64 * 1024)
    assert ct.max_k(64) == 8192 - ct.MERGE_THREADS
    with pytest.raises(ValueError, match="k <= 7168"):
        ct.launch_plan(10**6, 64, 7169)


# -- embedding_bag --------------------------------------------------------------


def _bags(v, d, n_bags, seed, lo=0):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(v, d)).astype(np.float32)
    lens = rng.integers(0, 9, n_bags)
    offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    indices = rng.integers(lo, v, int(lens.sum())).astype(np.int32)
    weights = rng.normal(size=len(indices)).astype(np.float32)
    return table, indices, offsets, weights


DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("v,d,n_bags", [(50, 16, 7), (500, 64, 32)])
def test_embedding_bag_matches_repro(dtype, mode, v, d, n_bags):
    """The sweep of ``tests/test_kernels.py``: the port's ``ops`` entry
    point against ``repro``'s (the Pallas kernel in interpret mode) and
    both references; -1 entries are skipped."""
    jdt, tdt, tol = DTYPES[dtype]
    table, indices, offsets, weights = _bags(v, d, n_bags, v + d, lo=-1)
    jtab = jnp.asarray(table, jdt)
    ttab = torch.from_numpy(table).to(tdt)
    want = jops.embedding_bag(jtab, indices, offsets, weights, mode=mode)
    want_ref = jref.embedding_bag_ref(jtab, jnp.asarray(indices),
                                      jnp.asarray(offsets),
                                      jnp.asarray(weights), mode=mode)
    got = ops.embedding_bag(ttab, torch.from_numpy(indices),
                            torch.from_numpy(offsets),
                            torch.from_numpy(weights), mode=mode)
    got_ref = ref.embedding_bag_ref(ttab, torch.from_numpy(indices),
                                    torch.from_numpy(offsets),
                                    torch.from_numpy(weights), mode=mode)
    assert got.dtype == tdt and got.shape == (n_bags, d)
    for a, b in ((got, want), (got_ref, want_ref), (got, want_ref)):
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b, np.float32),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("max_bag", [None, 3])
def test_embedding_bag_densify_matches_repro(max_bag, dtype):
    """Bags longer than ``max_bag`` are cut as ``repro``'s wrapper cuts
    them; without weights every entry weighs 1."""
    jdt, tdt, tol = DTYPES[dtype]
    table, indices, offsets, _ = _bags(40, 8, 12, 3)
    want = jops.embedding_bag(jnp.asarray(table, jdt), indices, offsets,
                              mode="sum", max_bag=max_bag)
    got = ops.embedding_bag(torch.from_numpy(table).to(tdt), indices,
                            offsets, mode="sum", max_bag=max_bag)
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)
    idx, w = ops.densify_bags(indices, offsets, None, max_bag, tdt, "cpu")
    lens = np.diff(offsets)
    mb = max_bag or int(lens.max())
    assert idx.shape == (12, mb) and (w[idx < 0] == 0).all()
    assert ((idx >= 0).sum(1).numpy() == np.minimum(lens, mb)).all()


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("max_bag", [None, 0, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embedding_bag_ragged_args_match_densify(dtype, max_bag, weighted):
    """What the ragged kernel reads -- bag b's entries offsets[b] ..
    min(offsets[b+1], offsets[b] + max_bag) of the flat arrays, -1 kept as
    a hole, weights rounded to the table's type (1 without weights) -- is
    the dense batch ``densify_bags`` builds for the plain version."""
    _, tdt, _ = DTYPES[dtype]
    table, indices, offsets, weights = _bags(40, 8, 12, 9, lo=-1)
    w_in = weights.astype(np.float64) if weighted else None
    a_idx, a_off, a_w, a_cut = eb.ragged_args(
        torch.from_numpy(table).to(tdt), indices, offsets.astype(np.int64),
        w_in, max_bag)
    assert a_idx.dtype == torch.int32 and a_off.dtype == torch.int64
    assert a_w is None if not weighted else a_w.dtype == tdt
    want_i, want_w = ops.densify_bags(indices, offsets, w_in, max_bag, tdt,
                                      "cpu")
    mb = want_i.shape[1]
    for b in range(len(offsets) - 1):
        s, e = int(a_off[b]), int(a_off[b + 1])
        n = max(0, min(e - s, a_cut))
        row_i = torch.full((mb,), -1, dtype=torch.int32)
        row_w = torch.zeros(mb, dtype=tdt)
        row_i[:n] = a_idx[s:s + n]
        row_w[:n] = (a_w[s:s + n].to(tdt) if weighted
                     else torch.ones(n, dtype=tdt))
        assert torch.equal(row_i, want_i[b]), b
        assert torch.equal(row_w, want_w[b]), b
    _, _, f32_w, cut = eb.ragged_args(torch.zeros(2, 2, dtype=tdt), [0],
                                      [0, 1], np.ones(1, np.float32))
    assert f32_w.dtype == torch.float32     # rounded in the kernel
    assert cut == eb.NO_CUT
    with pytest.raises(ValueError, match="max_bag"):
        eb.ragged_args(torch.zeros(2, 2), [0], [0, 1], None, -1)


def test_embedding_bag_dense_plain_clips_and_skips():
    table = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    idx = torch.tensor([[0, -1, 9], [-1, -1, -1]], dtype=torch.int32)
    w = torch.tensor([[2.0, 5.0, 1.0], [1.0, 1.0, 1.0]])
    got = eb.embedding_bag_dense(table, idx, w, mode="mean")
    assert got.tolist() == [[(0 * 2 + 9) / 2, (2 + 10) / 2, (4 + 11) / 2],
                            [0.0, 0.0, 0.0]]
    with pytest.raises(ValueError, match="mode"):
        eb.embedding_bag_dense(table, idx, w, mode="max")
