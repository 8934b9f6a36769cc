"""The backward of the bag that DIN's loss goes through on the card
(``repro_torch.kernels.embedding_bag``): its plain version, which the
kernel is held against in ``chip_smoke.py``, against ``jax.grad`` of
``repro``'s reference bag on the CPU, and autograd through the plain
forward (the CPU path) to the same gradients.

Tolerance: each gradient within 1e-5 of its largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import embedding_bag as teb
from torch_threads import one_torch_thread  # noqa: F401
from torch_train_cases import leaf_close

GRAD_TOL = 1e-5


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_bag_plain_backward_against_jax_grad(mode):
    """The bag's plain backward (what the kernel computes on the card)
    against ``jax.grad`` of ``repro``'s reference bag, on bags with -1
    pads, an index past the table (it reads the last row), an empty bag
    and the last row used for real."""
    r = np.random.default_rng(5)
    V, D, B, MB = 11, 7, 5, 6
    table = r.standard_normal((V, D)).astype(np.float32)
    idx = r.integers(0, V, (B, MB)).astype(np.int32)
    idx[r.random((B, MB)) < 0.3] = -1
    idx[2] = -1
    idx[0, 1], idx[3, 4] = V + 3, V - 1
    w = r.random((B, MB)).astype(np.float32)
    g = r.standard_normal((B, D)).astype(np.float32)
    offsets = jnp.arange(B + 1, dtype=jnp.int32) * MB

    def f(t, ww):
        out = jref.embedding_bag_ref(t, jnp.asarray(idx.reshape(-1)),
                                     offsets, ww.reshape(-1), mode)
        return jnp.sum(out * g)

    jt, jw = jax.grad(f, argnums=(0, 1))(table, w)
    dt, dw = teb.embedding_bag_dense_backward_plain(
        torch.from_numpy(table), torch.from_numpy(idx), torch.from_numpy(w),
        torch.from_numpy(g), mode)
    leaf_close(dt, jt, GRAD_TOL)
    leaf_close(dw, jw, GRAD_TOL)
    assert not dw[idx < 0].any()
    # the CPU path differentiates the plain forward to the same gradients
    tt = torch.from_numpy(table).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    (teb.embedding_bag_dense(tt, torch.from_numpy(idx), tw, mode)
     * torch.from_numpy(g)).sum().backward()
    leaf_close(tt.grad, jt, GRAD_TOL)
    leaf_close(tw.grad, jw, GRAD_TOL)
