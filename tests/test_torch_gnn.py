"""The port's GIN (``repro_torch.models.gnn``) and graph generators
(``repro_torch.data.graph``) against ``repro``'s on the CPU, at gin-tu's
smoke config: one parameter tree from ``repro``'s ``init_gin`` (its eps
set away from 0, so the learnable ``(1 + eps)`` term counts) goes to both
packages as numpy arrays, and both run on the same graphs.

Tolerances: node and graph logits within 1e-5 of ``repro``'s, relative to
their largest magnitude.  The generators equal ``repro``'s bit for bit.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import graph as jgraph
from repro.models import gnn as jgnn
from repro_torch.configs import get_arch
from repro_torch.data import graph as tgraph
from repro_torch.models import gnn as tgnn
from repro_torch.optim import grad_tree
from repro_torch.optim.optimizers import leaves
from torch_fast_jit import FAST
from torch_threads import one_torch_thread  # noqa: F401
from torch_train_cases import Case, jbatch, leaf_close, tbatch

TOL = 1e-5
N_NODES, N_EDGES, N_PAD = 60, 240, 9


def close(got, want, tol=TOL):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= tol * scale


def same(a, b):
    """Two generator outputs (a Graph, a dict, a tuple or an array) equal
    bit for bit, dtypes included."""
    if dataclasses.is_dataclass(a):
        a, b = dataclasses.asdict(a), dataclasses.asdict(b)
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        a, b = list(a.values()), list(b.values())
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            same(x, y)
        return
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    else:
        assert a == b


@pytest.fixture(scope="module")
def models():
    """(repro's params, the port's model, the port's config) at the smoke
    config, and the same with ``partitioned_edges=True``."""
    jcfg = jgnn.GINConfig(**dataclasses.asdict(
        get_arch("gin-tu").make_smoke_config()))
    jp, _ = jgnn.init_gin(jax.random.PRNGKey(2), jcfg)
    tree = jax.tree.map(np.asarray, jp)
    for i, lp in enumerate(tree["layers"]):
        lp["eps"] = np.float32(0.1 * (i + 1))
    cfg = get_arch("gin-tu").make_smoke_config()
    out = {}
    for part in (False, True):
        c = dataclasses.replace(cfg, partitioned_edges=part)
        out[part] = (jax.tree.map(jnp.asarray, tree),
                     dataclasses.replace(jcfg, partitioned_edges=part),
                     tgnn.params_from_numpy(tree, c, device="cpu"), c)
    return out


@pytest.fixture(scope="module")
def graph():
    cfg = get_arch("gin-tu").make_smoke_config()
    return tgraph.make_random_graph(N_NODES, N_EDGES, cfg.d_feat,
                                    cfg.n_classes, seed=3)


def test_generators_equal_repros():
    for kw in (dict(build_csr=True), dict(build_csr=False, seed=5)):
        same(tgraph.make_random_graph(80, 300, 12, 4, **kw),
             jgraph.make_random_graph(80, 300, 12, 4, **kw))
    ours_g = tgraph.make_random_graph(120, 700, 8, 5, seed=1)
    theirs_g = jgraph.make_random_graph(120, 700, 8, 5, seed=1)
    ours, theirs = (tgraph.NeighborSampler(ours_g, seed=2),
                    jgraph.NeighborSampler(theirs_g, seed=2))
    for args in (([0, 5, 9], (3, 2)), ([7, 1], (4, 3), 40, 64),
                 ([11], (2,))):
        same(ours.sample(np.asarray(args[0]), *args[1:]),
             theirs.sample(np.asarray(args[0]), *args[1:]))
    for shards, cap in ((4, 1.2), (3, 0.5)):
        same(tgraph.partition_edges_by_dst(ours_g, shards, cap),
             jgraph.partition_edges_by_dst(theirs_g, shards, cap))
    same(tgraph.make_molecule_batch(6, 30, 64, 32, 2, seed=4),
         jgraph.make_molecule_batch(6, 30, 64, 32, 2, seed=4))


def _padded(g):
    """The graph's edges with ``N_PAD`` -1 padded edges mixed in (a -1 at
    either end or both)."""
    rng = np.random.default_rng(7)
    src, dst = g.src.copy(), g.dst.copy()
    at = rng.choice(len(src), N_PAD, replace=False)
    src[at[:3]] = -1
    dst[at[3:6]] = -1
    src[at[6:]] = dst[at[6:]] = -1
    return (np.concatenate([src, np.full(4, -1, np.int32)]),
            np.concatenate([dst, np.full(4, -1, np.int32)]))


@pytest.mark.parametrize("partitioned", [False, True])
@pytest.mark.parametrize("edges", ["plain", "padded", "by-dst"])
def test_full_graph_matches_repro(models, graph, partitioned, edges):
    jp, jcfg, tp, cfg = models[partitioned]
    if edges == "plain":
        src, dst = graph.src, graph.dst
    elif edges == "padded":
        src, dst = _padded(graph)
    else:    # the dst-partitioned layout of 3 shards, -1 padded per shard
        src, dst, _ = tgraph.partition_edges_by_dst(graph, 3)
    want = jgnn.forward_full_graph(jp, jnp.asarray(graph.feats),
                                   jnp.asarray(src), jnp.asarray(dst), jcfg)
    with torch.no_grad():
        got = tp(torch.from_numpy(graph.feats), torch.from_numpy(src),
                 torch.from_numpy(dst))
    close(got, want)
    assert got.shape == (N_NODES, cfg.n_classes)


def test_sampled_subgraph_matches_repro(models, graph):
    jp, jcfg, tp, cfg = models[False]
    sub = tgraph.NeighborSampler(graph, seed=1).sample(
        np.arange(8), (3, 2), n_pad=64, e_pad=96)
    want = jgnn.forward_full_graph(jp, jnp.asarray(sub["feats"]),
                                   jnp.asarray(sub["src"]),
                                   jnp.asarray(sub["dst"]), jcfg)
    with torch.no_grad():
        got = tgnn.forward_full_graph(
            tp, *(torch.from_numpy(sub[k]) for k in ("feats", "src", "dst")),
            cfg)
    close(got, want)


@pytest.mark.parametrize("padded", [False, True])
def test_batched_graphs_match_repro(models, padded):
    jp, jcfg, tp, cfg = models[False]
    mb = tgraph.make_molecule_batch(5, 30, 64, cfg.d_feat, 2, seed=6)
    src, dst = mb["src"].copy(), mb["dst"].copy()
    if padded:
        src[:, -10:] = -1
        dst[1, :5] = -1
        src[2] = dst[2] = -1          # a graph without edges
    want = jgnn.forward_batched_graphs(jp, jnp.asarray(mb["feats"]),
                                       jnp.asarray(src), jnp.asarray(dst),
                                       jcfg)
    with torch.no_grad():
        got = tp(torch.from_numpy(mb["feats"]), torch.from_numpy(src),
                 torch.from_numpy(dst))
    close(got, want)
    assert got.shape == (5, cfg.n_classes)


def test_params_and_init(models):
    jp, _, tp, cfg = models[False]
    tree = tgnn.params_to_numpy(tp)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(jp)):
        assert np.array_equal(a, np.asarray(b))
    assert jax.tree.structure(tree) == jax.tree.structure(
        jax.tree.map(np.asarray, jp))
    fresh = tgnn.init_gin(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert jax.tree.map(np.shape, tgnn.params_to_numpy(fresh)) == \
        jax.tree.map(np.shape, tree)


@pytest.mark.parametrize("loss", ["loss_full_graph", "loss_batched_graphs"])
def test_losses_are_training(loss):
    """The loss, ``acc`` and every gradient leaf (eps included) against
    ``jax.value_and_grad`` of ``repro``'s: the launcher's sampled subgraph
    (-1 padded edges, a label mask) and a batch of molecules.  Loss
    within 1e-6 relative, each leaf within 1e-5 of its largest
    magnitude."""
    c = Case("gin-tu")
    if loss == "loss_full_graph":
        b = c.batch()
    else:
        b = jgraph.make_molecule_batch(6, 12, 30, c.jcfg.d_feat,
                                       c.jcfg.n_classes, seed=4)
        b["src"][0, :5] = -1
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        partial(getattr(jgnn, loss), cfg=c.jcfg), has_aux=True),
        compiler_options=FAST)(c.jparams(), jbatch(b))
    model = c.model().requires_grad_(True)
    tl, tm = getattr(tgnn, loss)(model, tbatch(b), c.tcfg)
    tl.backward()
    assert abs(float(tl.detach()) - float(jl)) <= 1e-6 * abs(float(jl))
    assert tm.keys() == jm.keys() == {"acc"}
    assert float(tm["acc"]) == float(jm["acc"])
    got, want = leaves(grad_tree(model)), jax.tree.leaves(jg)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        leaf_close(g, w, 1e-5)
