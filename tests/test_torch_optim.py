"""The port's optimizers (``repro_torch.optim``) and LM token stream
(``repro_torch.data.lm``) against ``repro``'s on the CPU.

One tree of numpy parameters and three steps of numpy gradients go to
both packages: a factored 2-D leaf, a 3-D leaf, an unfactored 1-D leaf, a
leaf of two rows (``min(shape[-2:]) < 2``) and a leaf the port holds a
tensor a layer (a tuple) where ``repro`` stacks it ``[L, ...]``, so
Adafactor's factored moments and its update-RMS clip see the stack.
Tolerances: parameters, state and metrics within 1e-6 of their scale
(float32 elementwise updates; ``repro`` compiles its own, the port runs
PyTorch's); the state's layout and the step equal.  ``TokenStream``
equals ``repro``'s bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import lm as jlm
from repro.optim import optimizers as jopt
from repro_torch.data import lm as tlm
from repro_torch.optim import optimizers as topt
from torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-6
SHAPES = {"a": (6, 5), "b": (3, 4, 7), "c": (9,), "d": (2, 1, 8)}
LAYERS, STACKED = 3, (4, 6)


def close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= tol * scale


def trees(seed):
    """(repro's tree, the port's tree) of one set of numpy arrays: the
    port's ``layers`` leaf a tuple of ``LAYERS`` tensors."""
    r = np.random.default_rng(seed)
    flat = {k: r.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}
    stacked = r.standard_normal((LAYERS,) + STACKED).astype(np.float32)
    jt = {**flat, "layers": {"w": stacked}, "list": [flat["c"] * 2]}
    tt = {**{k: torch.from_numpy(v.copy()) for k, v in flat.items()},
          "layers": {"w": tuple(torch.from_numpy(x.copy()) for x in stacked)},
          "list": [torch.from_numpy(flat["c"] * 2)]}
    return jt, tt


CONFIGS = [(name, clip) for name in ("adamw", "adafactor", "sgd")
           for clip in (1.0, 0.0)]


@pytest.mark.parametrize("name,clip", CONFIGS,
                         ids=[f"{n}-clip{c}" for n, c in CONFIGS])
def test_apply_updates_three_steps(name, clip):
    cfg = jopt.OptimizerConfig(name=name, lr=1e-2, warmup_steps=2,
                               decay_steps=10, clip_norm=clip,
                               weight_decay=0.05)
    tcfg = topt.OptimizerConfig(name=name, lr=1e-2, warmup_steps=2,
                                decay_steps=10, clip_norm=clip,
                                weight_decay=0.05)
    jp, tp = trees(0)
    jp = jax.tree.map(jnp.asarray, jp)
    js = jopt.init_optimizer(cfg, jp)
    ts = topt.init_optimizer(tcfg, tp)
    assert jax.tree.map(np.shape, jax.tree.map(np.asarray, js)) == \
        jax.tree.map(np.shape, topt.opt_state_to_numpy(ts))
    update = jax.jit(lambda p, g, s: jopt.apply_updates(cfg, p, g, s))
    for step in range(3):
        jg, tg = trees(10 + step)
        jp, js, jm = update(jp, jax.tree.map(jnp.asarray, jg), js)
        tp, ts, tm = topt.apply_updates(tcfg, tp, tg, ts)
        for a, b in zip(topt.leaves(tp), jax.tree.leaves(jp)):
            close(torch.stack(a) if isinstance(a, tuple) else a, b)
        for a, b in zip(topt.leaves(ts), jax.tree.leaves(js)):
            close(a, b)
        assert int(ts["step"]) == int(js["step"]) == step + 1
        close(tm["lr"], jm["lr"])
        close(tm["grad_norm"], jm["grad_norm"])


def test_lr_schedule_and_clipping():
    cfg = jopt.OptimizerConfig(lr=3e-4, warmup_steps=5, decay_steps=40,
                               min_lr_ratio=0.2)
    tcfg = topt.OptimizerConfig(lr=3e-4, warmup_steps=5, decay_steps=40,
                                min_lr_ratio=0.2)
    for s in (0, 1, 4, 5, 6, 20, 40, 41, 100):
        close(topt.lr_at(tcfg, torch.tensor(s, dtype=torch.int32)),
              jopt.lr_at(cfg, s))
    jt, tt = trees(4)
    for max_norm in (0.5, 1e9):
        jc, jn = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, jt),
                                          max_norm)
        tc, tn = topt.clip_by_global_norm(tt, max_norm)
        close(tn, jn)
        for a, b in zip(topt.leaves(tc), jax.tree.leaves(jc)):
            close(torch.stack(a) if isinstance(a, tuple) else a, b)


@pytest.mark.parametrize("name", ["adamw", "adafactor", "sgd"])
def test_state_crosses_both_ways(name):
    """``repro``'s state (after a step, so nothing is zero) into the port
    and back, array for array; the port's own init in ``repro``'s
    layout."""
    cfg = jopt.OptimizerConfig(name=name)
    jp, tp = trees(1)
    jp = jax.tree.map(jnp.asarray, jp)
    js = jopt.init_optimizer(cfg, jp)
    jg, _ = trees(2)
    _, js, _ = jax.jit(lambda p, g, s: jopt.apply_updates(cfg, p, g, s))(
        jp, jax.tree.map(jnp.asarray, jg), js)
    arrays = jax.tree.map(np.asarray, js)
    back = topt.opt_state_to_numpy(topt.opt_state_from_numpy(arrays, "cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(arrays)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(arrays)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    fresh = topt.opt_state_to_numpy(
        topt.init_optimizer(topt.OptimizerConfig(name=name), tp))
    want = jax.tree.map(np.asarray, jopt.init_optimizer(cfg, jp))
    assert jax.tree.structure(fresh) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(fresh), jax.tree.leaves(want)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_token_stream_bit_for_bit():
    for cfg_kw, start in ((dict(vocab=97, seq_len=33, global_batch=5), 0),
                          (dict(vocab=256, seq_len=16, global_batch=3,
                                seed=4), 7)):
        ours = tlm.TokenStream(tlm.LMDataConfig(**cfg_kw), start_step=start)
        theirs = jlm.TokenStream(jlm.LMDataConfig(**cfg_kw),
                                 start_step=start)
        for _ in range(3):
            a, b = ours.next_batch(), theirs.next_batch()
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
        assert ours.state() == theirs.state() == start + 3
