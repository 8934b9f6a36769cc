"""Weights for the LM parity tests: ``repro``'s ``init_lm`` tree layout
filled from a numpy seed, and the port's config of a ``repro`` config.

The tree's shapes come from ``jax.eval_shape`` (nothing is computed), so
both packages start from one set of numpy arrays: ``repro`` takes them as
they are, the port through ``params_from_numpy``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from repro.models import transformer as jtf
from repro_torch.models import transformer as ttf


def random_tree(cfg, seed: int) -> dict:
    """``repro``'s ``init_lm`` tree for ``cfg``, every leaf drawn from a
    numpy seed (norm weights around 1, biases nonzero) in ``param_dtype``."""
    shapes = jax.eval_shape(lambda: jtf.init_lm(jax.random.PRNGKey(0),
                                                cfg)[0])
    r = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        a = r.standard_normal(leaf.shape).astype(np.float32)
        a = 1 + 0.1 * a if "ln" in name else 0.02 * a
        return a.astype(leaf.dtype)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def port_cfg(cfg) -> ttf.TransformerConfig:
    return ttf.TransformerConfig(**dataclasses.asdict(cfg))


def both(cfg, seed: int):
    """(``repro``'s params, the port's model on the CPU) of one tree."""
    tree = random_tree(cfg, seed)
    return (jax.tree.map(jnp.asarray, tree),
            ttf.params_from_numpy(tree, port_cfg(cfg), device="cpu"))
