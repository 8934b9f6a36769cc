"""Optimizers: AdamW, Adafactor (factored second moment), SGD; warmup +
cosine schedule and global-norm clipping — ``repro``'s ``optim``, as plain
functions on trees of tensors.

A parameter tree is ``repro``'s: nested dicts (visited in sorted key
order) and lists of leaves.  A leaf is a tensor, or a tuple of tensors:
one leaf that ``repro`` stacks over the layers (``[L, ...]``) and the
port keeps a tensor a layer.  An ``nn.Module`` stands for its
``param_tree()``.  The optimizer state mirrors the tree in ``repro``'s
layout (a tuple leaf's moments are one stacked ``[L, ...]`` tensor), with
``repro``'s keys (``m``, ``v``, ``vr``, ``vc``, ``step``), so it converts
to and from ``repro``'s state array for array
(:func:`opt_state_to_numpy`, :func:`opt_state_from_numpy`).

:func:`apply_updates` runs the update rule itself under ``no_grad`` and
writes the new parameters and state in place, the gradient cast to
float32 per tensor.  AdamW and SGD are elementwise, so they update a
tuple leaf a layer at a time against views of its stacked moments (the
temporaries are one layer tensor's).  Adafactor stacks a tuple leaf for
its update, since its factored moments and its update-RMS clip see the
whole ``[L, ...]`` leaf, as ``repro``'s do.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn


@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"            # adamw | adafactor | sgd
    lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 1.0
    accum_steps: int = 1
    # adafactor
    factored_dims_min: int = 2
    decay_rate: float = 0.8


# -- trees ------------------------------------------------------------------


def as_tree(params):
    """A module's ``param_tree()``; a tree as it is."""
    return params.param_tree() if isinstance(params, nn.Module) else params


def leaves(tree) -> list:
    """The leaves in ``jax.tree.flatten``'s order (a tuple is one leaf)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the trees ``rest`` of its
    structure (tuples are leaves)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def _stacked(leaf) -> torch.Tensor:
    return torch.stack(leaf) if isinstance(leaf, tuple) else leaf


def _write(leaf, value: torch.Tensor) -> None:
    if isinstance(leaf, tuple):
        for part, v in zip(leaf, value):
            part.copy_(v)
    else:
        leaf.copy_(value)


def _shape(leaf) -> tuple:
    return ((len(leaf),) + tuple(leaf[0].shape) if isinstance(leaf, tuple)
            else tuple(leaf.shape))


def grad_tree(params):
    """The gradients of a parameter tree (a module's), as a tree of its
    structure: each parameter's ``.grad``, zeros where it has none (an
    unused parameter, as ``jax.grad`` gives it)."""
    def one(p):
        return p.grad if p.grad is not None else torch.zeros_like(p)

    return tree_map(lambda leaf: tuple(one(p) for p in leaf)
                    if isinstance(leaf, tuple) else one(leaf),
                    as_tree(params))


# -- schedule, clipping -------------------------------------------------------


def lr_at(cfg: OptimizerConfig, step):
    """Linear warmup to ``cfg.lr``, then cosine decay to ``min_lr_ratio``
    of it (float32, on the step's device)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp_max(step / max(cfg.warmup_steps, 1), 1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.decay_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def _is_factored(shape, cfg: OptimizerConfig) -> bool:
    return len(shape) >= cfg.factored_dims_min and min(shape[-2:]) >= 2


def global_norm(tree) -> torch.Tensor:
    total = None
    for leaf in leaves(tree):
        for x in (leaf if isinstance(leaf, tuple) else (leaf,)):
            s = torch.sum(torch.square(x.float()))
            total = s if total is None else total + s
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm):
    g = global_norm(grads)
    scale = torch.clamp_max(max_norm / torch.clamp_min(g, 1e-9), 1.0)
    return tree_map(lambda x: tuple(t * scale for t in x)
                    if isinstance(x, tuple) else x * scale, grads), g


# -- state ------------------------------------------------------------------


def init_optimizer(cfg: OptimizerConfig, params) -> dict:
    """Zero state for ``params`` (a module or a tree) on its device:
    float32 moments in ``repro``'s layout and an int32 step."""
    tree = as_tree(params)
    dev = leaves(tree)[0]
    dev = (dev[0] if isinstance(dev, tuple) else dev).device

    def zeros(shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    def full(p):
        return zeros(_shape(p))

    step = torch.zeros((), dtype=torch.int32, device=dev)
    if cfg.name == "adamw":
        return {"m": tree_map(full, tree), "v": tree_map(full, tree),
                "step": step}
    if cfg.name == "adafactor":
        def vr(p):
            s = _shape(p)
            return zeros(s[:-1] if _is_factored(s, cfg) else s)

        def vc(p):
            s = _shape(p)
            return zeros(s[:-2] + s[-1:] if _is_factored(s, cfg) else (1,))

        return {"vr": tree_map(vr, tree), "vc": tree_map(vc, tree),
                "step": step}
    if cfg.name == "sgd":
        return {"m": tree_map(full, tree), "step": step}
    raise ValueError(cfg.name)


def opt_state_to_numpy(state: dict) -> dict:
    """``repro``'s optimizer state of ``state``: the same keys and layout,
    numpy arrays."""
    return tree_map(lambda t: t.detach().cpu().numpy().copy(), state)


def opt_state_from_numpy(tree: dict, device="cuda") -> dict:
    """The port's optimizer state of ``repro``'s (``init_optimizer``'s
    tree or one after some steps), given as numpy arrays, on ``device``."""
    return tree_map(lambda a: torch.from_numpy(np.array(a)).to(device), tree)


# -- the update ---------------------------------------------------------------


def _parts(p, g, *moments):
    """``(p, g, *moments)`` a tensor at a time: a tuple leaf's layers
    against the rows of its stacked moments, else the leaf itself."""
    if isinstance(p, tuple):
        return zip(p, g, *(list(x) for x in moments))
    return ((p, g) + moments,)


def _adamw(cfg, p, g, m, v, scale, lr, bc1, bc2):
    """One tensor's AdamW step, ``p``, ``m`` and ``v`` in place."""
    g = g.float() * scale
    m.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
    v.mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
    u = torch.div(v, bc2).sqrt_().add_(cfg.eps)
    u = torch.div(m, bc1).div_(u)
    pf = p.float()
    u.add_(pf, alpha=cfg.weight_decay).mul_(lr)
    if pf is p:
        p.sub_(u)
    else:
        p.copy_(pf - u)


def _adafactor(cfg, p, g, vr, vc, scale, lr, beta2):
    g = g.float() * scale
    g2 = g * g + 1e-30
    if _is_factored(p.shape, cfg):
        vr2 = beta2 * vr + (1 - beta2) * g2.mean(dim=-1)
        vc2 = beta2 * vc + (1 - beta2) * g2.mean(dim=-2)
        r_factor = vr2 / torch.clamp_min(vr2.mean(dim=-1, keepdim=True),
                                         1e-30)
        u = g * torch.rsqrt(r_factor)[..., None] \
            * torch.rsqrt(vc2 / 1.0)[..., None, :]
    else:
        vr2 = beta2 * vr + (1 - beta2) * g2
        vc2 = vc
        u = g * torch.rsqrt(vr2)
    # update clipping (RMS <= 1)
    rms = torch.sqrt(torch.mean(u * u) + 1e-30)
    u = u / torch.clamp_min(rms, 1.0)
    u = u + cfg.weight_decay * p.float()
    return (p.float() - lr * u).to(p.dtype), vr2, vc2


@torch.no_grad()
def apply_updates(cfg: OptimizerConfig, params, grads, state: dict):
    """One optimizer step: ``(params, state, metrics)``, the parameters
    (a module or a tree) and the state updated in place and returned,
    metrics ``lr`` and ``grad_norm`` (0-d float32 tensors on the
    device)."""
    tree = as_tree(params)
    gnorm = global_norm(grads)
    scale = torch.ones((), dtype=torch.float32, device=gnorm.device)
    if cfg.clip_norm > 0:
        scale = torch.clamp_max(cfg.clip_norm / torch.clamp_min(gnorm, 1e-9),
                                1.0)
    step = state["step"] + 1
    lr = lr_at(cfg, step)
    step_f = step.to(torch.float32)
    flat_p, flat_g = leaves(tree), leaves(grads)
    if cfg.name == "adamw":
        bc1 = 1 - cfg.b1 ** step_f
        bc2 = 1 - cfg.b2 ** step_f
        for p, g, m, v in zip(flat_p, flat_g, leaves(state["m"]),
                              leaves(state["v"])):
            for args in _parts(p, g, m, v):
                _adamw(cfg, *args, scale, lr, bc1, bc2)
    elif cfg.name == "adafactor":
        beta2 = 1.0 - step_f ** (-cfg.decay_rate)
        for p, g, vr, vc in zip(flat_p, flat_g, leaves(state["vr"]),
                                leaves(state["vc"])):
            new_p, vr2, vc2 = _adafactor(cfg, _stacked(p), _stacked(g), vr,
                                         vc, scale, lr, beta2)
            _write(p, new_p)
            vr.copy_(vr2)
            vc.copy_(vc2)
    elif cfg.name == "sgd":
        for p, g, m in zip(flat_p, flat_g, leaves(state["m"])):
            for pi, gi, mi in _parts(p, g, m):
                mi.mul_(cfg.b1).add_(gi.float() * scale)
                pi.copy_(pi.float() - lr * mi)
    else:
        raise ValueError(cfg.name)
    state["step"].copy_(step)
    return params, state, {"lr": lr, "grad_norm": gnorm}
