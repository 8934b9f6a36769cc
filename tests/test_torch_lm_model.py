"""The port's transformer (``repro_torch.models.transformer``) against
``repro``'s on the CPU, at the five LM archs' smoke configs: one weight
tree in ``repro``'s layout, made from a numpy seed, goes to both packages
(``params_from_numpy`` for the port), and ``forward``, ``prefill`` and
``decode_step`` run on the same tokens.

Tolerances: float32 hidden states and logits within 1e-4 of ``repro``'s
(relative to the largest magnitude, at least 1) and greedy tokens equal;
with bfloat16 activations logits within 2e-2 and tokens equal wherever
``repro``'s top two logits are further apart than that.  int8 cache
values and positions equal.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as repro_arch
from repro.models import transformer as jtf
from repro_torch.configs import LM_ARCHS, get_arch
from repro_torch.models import transformer as ttf
from torch_lm_trees import port_cfg, random_tree
from torch_threads import one_torch_thread  # noqa: F401

TOL, BF16_TOL = 1e-4, 2e-2
DECODE_STEPS = 3


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x).astype(np.float32)   # no JAX op to compile


def close(got, want, tol=TOL):
    got, want = f32(got), f32(want)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, scale)


class Pair:
    """One config's weights in both packages, and ``repro``'s forward
    compiled once."""

    def __init__(self, cfg, seed=1):
        self.cfg, self.tcfg = cfg, port_cfg(cfg)
        tree = random_tree(cfg, seed)
        self.jp = jax.tree.map(jnp.asarray, tree)
        self.tp = ttf.params_from_numpy(tree, self.tcfg, device="cpu")
        self.forward = jax.jit(partial(jtf.forward, cfg=cfg))


@pytest.fixture(scope="module", params=LM_ARCHS)
def pair(request):
    return Pair(repro_arch(request.param).make_smoke_config())


def tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape,
                                                dtype=np.int32)


def test_forward(pair):
    toks = tokens(pair.cfg, (2, 21))
    xj, aux_j = pair.forward(pair.jp, jnp.asarray(toks))
    xt, aux_t = ttf.forward(pair.tp, torch.as_tensor(toks), pair.tcfg)
    close(xt, xj)
    close(aux_t, aux_j)
    close(pair.tp(torch.as_tensor(toks))[0], xj)   # nn.Module.forward


def _prefill_decode(pair, cfg_j, cfg_t, cache_j, cache_t, toks, max_len,
                    tol=TOL):
    """Prefill ``toks`` and decode greedily in both packages; every step's
    logits close and tokens equal (where the top two are apart)."""
    lj, cj = jax.jit(partial(jtf.prefill, cfg=cfg_j, max_len=max_len,
                             cache_dtype=cache_j))(pair.jp, jnp.asarray(toks))
    lt, ct = ttf.prefill(pair.tp, torch.as_tensor(toks), cfg_t, max_len,
                         cache_dtype=cache_t)
    decode = jax.jit(partial(jtf.decode_step, cfg=cfg_j))
    for step in range(DECODE_STEPS + 1):
        close(lt, lj, tol)
        assert ct.keys() == cj.keys()
        for name in ct:
            if ct[name].dtype in (torch.int8, torch.int32):
                assert np.array_equal(ct[name].numpy(), np.asarray(cj[name]))
            else:
                assert ct[name].dtype == getattr(torch, cj[name].dtype.name)
                close(ct[name], cj[name], tol)
        lj_np = f32(lj)
        want = lj_np.argmax(-1).astype(np.int32)
        top2 = np.sort(lj_np, -1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > 2 * tol * max(
            1.0, float(np.abs(lj_np).max()))
        got = lt.argmax(-1).numpy()
        assert (got[clear] == want[clear]).all()
        if step == DECODE_STEPS:
            return
        lj, cj = decode(pair.jp, cj, jnp.asarray(want))
        lt, ct = ttf.decode_step(pair.tp, ct, torch.from_numpy(want), cfg_t)


@pytest.mark.parametrize("cache", ["float32", "int8"])
def test_prefill_and_decode(pair, cache):
    """float32: the server's cache; int8: the quantized cache with its
    scales (prefill quantizes the bfloat16 cache).  Prompts of 20 tokens
    wrap danube's 16-position window inside the prefill."""
    cfg_j, cfg_t = pair.cfg, pair.tcfg
    if cache == "int8":
        cfg_j = dataclasses.replace(cfg_j, cache_dtype="int8")
        cfg_t = dataclasses.replace(cfg_t, cache_dtype="int8")
        dtypes = (jnp.bfloat16, torch.bfloat16)
    else:
        dtypes = (jnp.float32, torch.float32)
    _prefill_decode(pair, cfg_j, cfg_t, *dtypes, tokens(cfg_j, (2, 20)), 32)


def test_bf16_activations():
    """danube's smoke config at its full config's activation dtype: the
    residual stream bfloat16 in prefill, float32 in decode, as repro's."""
    cfg = dataclasses.replace(repro_arch("h2o-danube-1.8b")
                              .make_smoke_config(),
                              activation_dtype="bfloat16")
    pair = Pair(cfg, seed=2)
    toks = tokens(cfg, (2, 12), seed=3)
    xj, _ = pair.forward(pair.jp, jnp.asarray(toks))
    xt, _ = ttf.forward(pair.tp, torch.as_tensor(toks), pair.tcfg)
    assert xj.dtype == jnp.bfloat16 and xt.dtype == torch.bfloat16
    close(xt, xj, BF16_TOL)
    _prefill_decode(pair, cfg, pair.tcfg, jnp.bfloat16, torch.bfloat16, toks,
                    24, BF16_TOL)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_specs_and_configs_match_repro(arch):
    ours, theirs = get_arch(arch), repro_arch(arch)
    assert (ours.family, ours.source, ours.notes) == \
        (theirs.family, theirs.source, theirs.notes)
    assert dataclasses.asdict(ours.optimizer) == \
        dataclasses.asdict(theirs.optimizer)
    assert {k: dataclasses.asdict(v) for k, v in ours.shapes.items()} == \
        {k: dataclasses.asdict(v) for k, v in theirs.shapes.items()}
    for make in ("make_config", "make_smoke_config"):
        a, b = getattr(ours, make)(), getattr(theirs, make)()
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert (a.padded_vocab, a.is_moe, a.param_count(),
                a.active_param_count()) == \
            (b.padded_vocab, b.is_moe, b.param_count(),
             b.active_param_count())


def test_init_lm_and_numpy_roundtrip():
    """init_lm draws from the generator (reproducibly), in param_dtype;
    params_to_numpy gives repro's layout back, and params_from_numpy of it
    is the same model."""
    cfg = dataclasses.replace(get_arch("arctic-480b").make_smoke_config(),
                              param_dtype="bfloat16")   # the full config's
    a = ttf.init_lm(torch.Generator().manual_seed(5), cfg, device="cpu")
    b = ttf.init_lm(torch.Generator().manual_seed(5), cfg, device="cpu")
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k])
                                          for k in sa)
    assert all(p.dtype == torch.bfloat16 and not p.requires_grad
               for p in a.parameters())
    tree = ttf.params_to_numpy(a)
    want = jax.eval_shape(lambda: jtf.init_lm(jax.random.PRNGKey(0),
                                              cfg)[0])
    assert jax.tree.structure(jax.tree.map(np.shape, tree)) == \
        jax.tree.structure(jax.tree.map(lambda x: x.shape, want))
    assert jax.tree.leaves(jax.tree.map(np.shape, tree)) == \
        jax.tree.leaves(jax.tree.map(lambda x: x.shape, want))
    c = ttf.params_from_numpy(tree, cfg, device="cpu").state_dict()
    assert all(torch.equal(sa[k], c[k]) for k in sa)
    assert a.n_params() == sum(x.size for x in jax.tree.leaves(tree))
