"""The off-path kernels' entry points in the port against the JAX package:
``ops.candidate_topk`` (fused dot scoring + top-k) and
``ops.embedding_bag`` (ragged gather + sum or mean).

On the CPU the port's wrappers answer with their plain versions; the same
numpy inputs go through the Pallas kernels (interpret mode) and
``repro.kernels.ref``.  The CUDA kernels are held against these plain
versions on the card by ``chip_smoke.py``.

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


def test_candidate_topk_launch_plan():
    """Pass 1 sizes its tiles to the shared memory a block has, pass 2
    merges 8,192 keys a block; shapes past either raise."""
    block_c, sort_n, tile_rows, shared, group = ct.launch_plan(
        1_000_000, 64, 100, 1024)
    assert (block_c, sort_n, tile_rows, group) == (1024, 1024, 256, 64)
    assert shared == 8 * 1024 + 4 * 64 + 4 * 65 * 256 <= 232_448
    assert ct.launch_plan(300, 8, 5, 1024)[:2] == (300, 512)
    assert ct.launch_plan(10, 20_000, 5, 1024)[2] == 1
    with pytest.raises(ValueError, match="shared memory"):
        ct.launch_plan(10, 60_000, 5, 1024)
    with pytest.raises(ValueError, match="k <="):
        ct.launch_plan(10**6, 64, 5000, 1024)


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


@pytest.mark.parametrize("max_bag", [None, 3])
def test_embedding_bag_densify_matches_repro(max_bag):
    """Bags longer than ``max_bag`` are cut as ``repro``'s wrapper cuts
    them; without weights every entry weighs 1."""
    table, indices, offsets, _ = _bags(40, 8, 12, 3)
    want = jops.embedding_bag(jnp.asarray(table), indices, offsets,
                              mode="sum", max_bag=max_bag)
    got = ops.embedding_bag(torch.from_numpy(table), indices, offsets,
                            mode="sum", max_bag=max_bag)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    idx, w = ops.densify_bags(indices, offsets, None, max_bag,
                              torch.float32, "cpu")
    lens = np.diff(offsets)
    mb = max_bag or int(lens.max())
    assert idx.shape == (12, mb) and (w[idx < 0] == 0).all()
    assert ((idx >= 0).sum(1).numpy() == np.minimum(lens, mb)).all()


def test_embedding_bag_dense_plain_clips_and_skips():
    table = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    idx = torch.tensor([[0, -1, 9], [-1, -1, -1]], dtype=torch.int32)
    w = torch.tensor([[2.0, 5.0, 1.0], [1.0, 1.0, 1.0]])
    got = eb.embedding_bag_dense(table, idx, w, mode="mean")
    assert got.tolist() == [[(0 * 2 + 9) / 2, (2 + 10) / 2, (4 + 11) / 2],
                            [0.0, 0.0, 0.0]]
    with pytest.raises(ValueError, match="mode"):
        eb.embedding_bag_dense(table, idx, w, mode="max")
