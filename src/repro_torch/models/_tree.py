"""Modules that keep ``repro``'s parameter trees as they are: nested dicts
and lists of arrays become submodules and parameters under the same keys
(``m.bot.w[0]`` for ``tree["bot"]["w"][0]``), so ``.to(device)`` and
``state_dict()`` reach every leaf and the model functions read the tree
by ``repro``'s names."""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


def param(t: torch.Tensor) -> nn.Parameter:
    # serving weights; a train step turns gradients on for its own model
    return nn.Parameter(t, requires_grad=False)


def fill(m: nn.Module, tree: dict) -> nn.Module:
    """``m`` with the dict ``tree``'s tensors as its parameters and its
    subtrees as its submodules (:func:`to_module`)."""
    for k, v in tree.items():
        if isinstance(v, torch.Tensor):
            m.register_parameter(k, param(v))
        else:
            m.add_module(k, to_module(v))
    return m


def to_module(tree) -> nn.Module:
    """A dict or list tree of tensors as a module: a dict as :func:`fill`
    makes it; a list of tensors an ``nn.ParameterList``, a list of
    subtrees an ``nn.ModuleList``."""
    if isinstance(tree, dict):
        return fill(nn.Module(), tree)
    if all(isinstance(v, torch.Tensor) for v in tree):
        return nn.ParameterList(param(v) for v in tree)
    return nn.ModuleList(to_module(v) for v in tree)


def to_tree(m: nn.Module):
    """The inverse of :func:`to_module`: the module's tree of tensors."""
    if isinstance(m, nn.ParameterList):
        return list(m)
    if isinstance(m, nn.ModuleList):
        return [to_tree(c) for c in m]
    out = dict(m.named_parameters(recurse=False))
    out.update((k, to_tree(c)) for k, c in m.named_children())
    return out


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def from_numpy_tree(tree) -> dict:
    """``repro``'s tree of numpy arrays as float32 CPU tensors (one copy)."""
    return tree_map(lambda a: torch.from_numpy(
        np.array(a, dtype=np.float32)), tree)


def to_numpy_tree(m: nn.Module) -> dict:
    return tree_map(lambda t: t.detach().cpu().numpy(), to_tree(m))


def stack_leaves(trees: list):
    """Trees of one structure as one tree whose leaves are tuples (leaf i
    of each tree, in order): ``repro``'s leaves stacked over layers."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: stack_leaves([t[k] for t in trees]) for k in first}
    if isinstance(first, list):
        return [stack_leaves([t[i] for t in trees])
                for i in range(len(first))]
    return tuple(trees)
