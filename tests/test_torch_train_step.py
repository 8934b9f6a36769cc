"""The port's train step (``repro_torch.configs.cells.make_train_step``)
against ``repro``'s on the CPU, for each of the ten archs at its smoke
config with the arch's own optimizer (Adafactor for arctic, AdamW for the
rest).

``repro`` runs two steps from one numpy tree; its parameters and
optimizer state then cross into the port (``params_from_numpy``,
``opt_state_from_numpy``), and both packages take a third step on the
same batch (``tests/torch_train_cases.py``).  Accumulation over two
micro-batches is compared on two dense configs: an MoE's routing depends
on the tokens of a call, so micro-batching changes an MoE's answer in
``repro`` too.

Tolerances: the loss and metrics within 1e-6 relative; the updated
parameters within 1e-5 of each leaf's largest magnitude; the optimizer
state within 2e-5 (its second moments square the gradients' 1e-6
differences); the step and the metric keys equal.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.cells import make_train_step as jmake
from repro.optim import init_optimizer as jinit
from repro_torch.configs.cells import make_train_step as tmake
from repro_torch.optim import opt_state_from_numpy
from repro_torch.optim.optimizers import leaves
from torch_fast_jit import FAST
from torch_threads import one_torch_thread  # noqa: F401
from torch_train_cases import ARCHS, Case, jbatch, leaf_close, tbatch

LOSS_TOL, PARAM_TOL, STATE_TOL = 1e-6, 1e-5, 2e-5


def crossed(case, opt, warm_steps=2):
    """``repro``'s jitted step after ``warm_steps`` steps, its (params,
    state), and the port's model and state made from them."""
    jstep = jax.jit(jmake(case.jloss, case.jcfg, opt),
                    compiler_options=FAST)
    jp = case.jparams()
    jo = jinit(opt, jp)
    for _ in range(warm_steps):
        jp, jo, _ = jstep(jp, jo, jbatch(case.batch()))
    model = case.model(jax.tree.map(np.asarray, jp))
    to = opt_state_from_numpy(jax.tree.map(np.asarray, jo), "cpu")
    return jstep, jp, jo, model, to


def same_step(jout, tout):
    (jp, jo, jm), (model, to, tm) = jout, tout
    assert tm.keys() == jm.keys()
    for k in jm:
        leaf_close(tm[k], jm[k], LOSS_TOL, k)
    for got, want in zip(leaves(model.param_tree()), jax.tree.leaves(jp)):
        leaf_close(got, want, PARAM_TOL)
    assert int(to["step"]) == int(jo["step"])
    got, want = leaves(to), jax.tree.leaves(jo)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        leaf_close(g, w, STATE_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step(arch):
    c = Case(arch)
    jstep, jp, jo, model, to = crossed(c, c.opt)
    b = c.batch()
    jout = jstep(jp, jo, jbatch(b))
    before = [p.detach().clone() for p in model.parameters()]
    tout = tmake(c.tloss, c.tcfg, c.opt)(model, to, tbatch(b))
    same_step(jout, tout)
    assert tout[0] is model and tout[1] is to        # updated in place
    assert all(p.requires_grad and p.grad is None for p in model.parameters())
    assert any(not torch.equal(a, p) for a, p in zip(before,
                                                     model.parameters()))
    assert set(tout[2]) >= {"loss", "lr", "grad_norm"}


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "din"])
def test_accumulation(arch):
    """``accum_steps=2``: the batch's halves in order, gradients summed in
    the parameters' dtype and halved, loss and metrics their means."""
    c = Case(arch)
    opt = dataclasses.replace(c.opt, accum_steps=2)
    jstep, jp, jo, model, to = crossed(c, opt, warm_steps=1)
    b = c.batch()
    same_step(jstep(jp, jo, jbatch(b)),
              tmake(c.tloss, c.tcfg, opt)(model, to, tbatch(b)))
