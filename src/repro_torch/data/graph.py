"""Graph data: generators for the four GIN shape regimes + a real neighbor
sampler (CSR adjacency, uniform fanout, padded renumbered subgraphs) as the
assignment requires for minibatch_lg.

A copy of ``repro``'s ``data/graph.py`` (numpy only): its outputs equal
``repro``'s bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Graph:
    n_nodes: int
    src: np.ndarray      # int32[E]
    dst: np.ndarray      # int32[E]
    feats: np.ndarray    # float32[N, d]
    labels: np.ndarray   # int32[N]
    row_ptr: np.ndarray | None = None   # CSR over incoming edges (dst-major)
    col_idx: np.ndarray | None = None


def make_random_graph(n_nodes: int, n_edges: int, d_feat: int,
                      n_classes: int, seed: int = 0,
                      build_csr: bool = True) -> Graph:
    """Power-law-ish random graph with class-correlated features."""
    rng = np.random.default_rng(seed)
    # preferential-attachment flavoured endpoints
    w = rng.zipf(1.6, n_nodes).astype(np.float64)
    p = w / w.sum()
    src = rng.choice(n_nodes, size=n_edges, p=p).astype(np.int32)
    dst = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    labels = rng.integers(0, n_classes, n_nodes).astype(np.int32)
    centers = rng.normal(size=(n_classes, d_feat)).astype(np.float32)
    feats = centers[labels] + rng.normal(
        scale=1.0, size=(n_nodes, d_feat)).astype(np.float32)
    g = Graph(n_nodes, src, dst, feats, labels)
    if build_csr:
        order = np.argsort(dst, kind="stable")
        g.col_idx = src[order]
        counts = np.bincount(dst, minlength=n_nodes)
        g.row_ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    return g


class NeighborSampler:
    """GraphSAGE-style uniform neighbor sampler over CSR adjacency.

    sample(seeds, fanouts) returns a renumbered, padded subgraph:
      feats [N_pad, d], src/dst int32[E_pad] (-1 pad), seed nodes are the
      first len(seeds) rows, labels/mask aligned.
    """

    def __init__(self, g: Graph, seed: int = 0):
        assert g.row_ptr is not None, "graph needs CSR"
        self.g = g
        self.rng = np.random.default_rng(seed)

    def sample(self, seeds: np.ndarray, fanouts: tuple[int, ...],
               n_pad: int | None = None, e_pad: int | None = None):
        g = self.g
        seeds = np.asarray(seeds, np.int64)
        frontier = seeds
        nodes = list(seeds)
        node_pos = {int(v): i for i, v in enumerate(seeds)}
        edges_src: list[int] = []
        edges_dst: list[int] = []
        for f in fanouts:
            deg = g.row_ptr[frontier + 1] - g.row_ptr[frontier]
            nxt = []
            for v, d in zip(frontier, deg):
                if d == 0:
                    continue
                take = min(f, int(d))
                offs = self.rng.choice(int(d), size=take,
                                       replace=int(d) < take)
                neigh = g.col_idx[g.row_ptr[v] + offs]
                for u in neigh:
                    u = int(u)
                    if u not in node_pos:
                        node_pos[u] = len(nodes)
                        nodes.append(u)
                        nxt.append(u)
                    edges_src.append(node_pos[u])
                    edges_dst.append(node_pos[int(v)])
            frontier = np.asarray(nxt, np.int64) if nxt else \
                np.zeros((0,), np.int64)
        nodes = np.asarray(nodes, np.int64)
        n_pad = n_pad or len(nodes)
        e_pad = e_pad or max(len(edges_src), 1)
        feats = np.zeros((n_pad, g.feats.shape[1]), np.float32)
        feats[: len(nodes)] = g.feats[nodes[:n_pad]]
        labels = np.zeros((n_pad,), np.int32)
        labels[: len(nodes)] = g.labels[nodes[:n_pad]]
        mask = np.zeros((n_pad,), bool)
        mask[: len(seeds)] = True
        src = np.full((e_pad,), -1, np.int32)
        dst = np.full((e_pad,), -1, np.int32)
        ne = min(len(edges_src), e_pad)
        src[:ne] = np.asarray(edges_src[:ne], np.int32)
        dst[:ne] = np.asarray(edges_dst[:ne], np.int32)
        return {"feats": feats, "src": src, "dst": dst,
                "labels": labels, "label_mask": mask}


def partition_edges_by_dst(g: Graph, n_shards: int,
                           capacity_factor: float = 1.2):
    """Locality-aware edge layout (§Perf): shard i owns edges whose dst is in
    node range [i*n_local, (i+1)*n_local). Returns (src, dst) int32 arrays of
    length n_shards*cap (-1 padded per shard; drops beyond capacity are
    counted and returned)."""
    n_local = -(-g.n_nodes // n_shards)
    owner = g.dst // n_local
    order = np.argsort(owner, kind="stable")
    src, dst = g.src[order], g.dst[order]
    counts = np.bincount(owner, minlength=n_shards)
    cap = int(counts.mean() * capacity_factor) + 1
    out_src = np.full((n_shards, cap), -1, np.int32)
    out_dst = np.full((n_shards, cap), -1, np.int32)
    starts = np.concatenate([[0], np.cumsum(counts)])
    dropped = 0
    for i in range(n_shards):
        e = src[starts[i]:starts[i + 1]]
        d = dst[starts[i]:starts[i + 1]]
        take = min(len(e), cap)
        dropped += len(e) - take
        out_src[i, :take] = e[:take]
        out_dst[i, :take] = d[:take]
    return out_src.reshape(-1), out_dst.reshape(-1), dropped


def make_molecule_batch(batch: int, n_nodes: int, n_edges: int, d_feat: int,
                        n_classes: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(batch, n_nodes, d_feat)).astype(np.float32)
    src = rng.integers(0, n_nodes, (batch, n_edges)).astype(np.int32)
    dst = rng.integers(0, n_nodes, (batch, n_edges)).astype(np.int32)
    labels = rng.integers(0, n_classes, (batch,)).astype(np.int32)
    return {"feats": feats, "src": src, "dst": dst, "labels": labels}
