"""The port's training losses against ``repro``'s on the CPU: the chunked
cross-entropy, the LM's ``loss_fn`` at the five LM archs' smoke configs
(with the MoE's load-balance loss), and remat on and off.

One numpy tree goes to both packages (``tests/torch_train_cases.py``);
``repro``'s side is ``jax.value_and_grad``, the port's ``backward()``.
Tolerances: losses within 1e-6 relative, each gradient leaf within 1e-5
of its largest magnitude; remat changes nothing (equal bit for bit).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jL
from repro_torch.configs import LM_ARCHS
from repro_torch.models import layers as tL
from repro_torch.models import transformer as ttf
from repro_torch.optim import grad_tree
from repro_torch.optim.optimizers import leaves
from torch_fast_jit import FAST
from torch_threads import one_torch_thread  # noqa: F401
from torch_train_cases import Case, as_np, jbatch, leaf_close, tbatch

LOSS_TOL, GRAD_TOL = 1e-6, 1e-5


def loss_close(got, want):
    got = float(got.detach()) if isinstance(got, torch.Tensor) else float(got)
    want = float(want)
    assert abs(got - want) <= LOSS_TOL * max(abs(want), 1e-30), (got, want)


XENT = [  # (B, S, D, V, chunk, vocab_real, masked, reduce)
    (2, 10, 8, 16, 4, None, False, "mean"),     # S pads to 12
    (3, 7, 6, 32, 16, 27, True, "mean"),        # one chunk, padded vocab
    (2, 12, 8, 24, 5, 20, True, "sum"),
]


@pytest.mark.parametrize("case", XENT, ids=[f"case{i}" for i in range(3)])
def test_xent_loss_chunked(case):
    B, S, D, V, chunk, vocab_real, masked, reduce = case
    r = np.random.default_rng(S)
    x = r.standard_normal((B, S, D)).astype(np.float32)
    w = r.standard_normal((D, V)).astype(np.float32) * 0.3
    tgt = r.integers(0, vocab_real or V, (B, S)).astype(np.int32)
    mask = (r.random((B, S)) < 0.7) if masked else None

    def jf(x, w):
        out = jL.xent_loss_chunked(x, w, jnp.asarray(tgt),
                                   None if mask is None else
                                   jnp.asarray(mask), chunk=chunk,
                                   vocab_real=vocab_real, reduce=reduce)
        return out[0] if reduce == "sum" else out

    jl, (gx, gw) = jax.value_and_grad(jf, argnums=(0, 1))(x, w)
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    args = (torch.from_numpy(tgt),
            None if mask is None else torch.from_numpy(mask))
    kw = dict(chunk=chunk, vocab_real=vocab_real, reduce=reduce)
    out = tL.xent_loss_chunked(tx, tw, *args, **kw)
    tl = out[0] if reduce == "sum" else out
    if reduce == "sum":
        assert float(out[1]) == float(np.sum(mask))
    tl.backward()
    loss_close(tl, jl)
    leaf_close(tx.grad, gx, GRAD_TOL)
    leaf_close(tw.grad, gw, GRAD_TOL)
    with torch.no_grad():      # no checkpoint outside grad mode
        again = tL.xent_loss_chunked(tx, tw, *args, **kw)
    assert torch.equal(again[0] if reduce == "sum" else again, tl.detach())


@pytest.fixture(scope="module", params=LM_ARCHS)
def lm_case(request):
    return Case(request.param)


def test_loss_fn(lm_case):
    """``loss_fn``'s loss, metrics and every gradient leaf."""
    c = lm_case
    b = c.batch()
    vg = jax.jit(jax.value_and_grad(partial(c.jloss, cfg=c.jcfg),
                                    has_aux=True), compiler_options=FAST)
    (jl, jm), jg = vg(c.jparams(), jbatch(b))
    model = c.model().requires_grad_(True)
    tl, tm = c.tloss(model, tbatch(b), c.tcfg)
    tl.backward()
    loss_close(tl, jl)
    assert tm.keys() == jm.keys() == {"nll", "aux"}
    loss_close(tm["nll"], jm["nll"])
    leaf_close(tm["aux"], jm["aux"], LOSS_TOL)
    got = leaves(grad_tree(model))
    want = jax.tree.leaves(jg)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        leaf_close(g, w, GRAD_TOL)
    if c.tcfg.is_moe:
        assert float(jm["aux"]) > 0


def test_remat_gives_equal_gradients(lm_case):
    c = lm_case
    b = tbatch(c.batch())
    grads = []
    for remat in (True, False):
        cfg = ttf.TransformerConfig(**{**c.tcfg.__dict__, "remat": remat})
        model = c.model().requires_grad_(True)
        loss, _ = ttf.loss_fn(model, b, cfg)
        loss.backward()
        grads.append((loss.detach(), [as_np(g)
                                      for g in leaves(grad_tree(model))]))
    assert torch.equal(grads[0][0], grads[1][0])
    for a, b_ in zip(grads[0][1], grads[1][1]):
        assert np.array_equal(a, b_)
