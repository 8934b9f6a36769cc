"""GIN (Graph Isomorphism Network, arXiv:1810.00826) on scatter-add message
passing — ``repro``'s ``models/gnn.py`` on one device: the forwards and
the two losses.

``repro``'s ``segment_sum`` over an edge index is ``index_add_`` here: the
messages ``h[src]`` are gathered once, masked in place (a ``-1`` edge
contributes 0), and added into their ``dst`` rows.  On the card
``index_add_``'s float atomics add in no fixed order, so the result equals
``repro``'s to a tolerance, not bit for bit.  GIN's BatchNorm is a
stateless LayerNorm (eps 1e-5) as in ``repro``; eps stays learnable.

Autograd differentiates the losses (``index_add_``'s backward is a
gather).  The mesh arms (``_aggregate``'s ``psum``,
``_aggregate_partitioned``'s ``all_gather``; on one device
``_aggregate_partitioned`` is ``_aggregate``) are ROADMAP.md §1 item 12.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import _tree


@dataclass(frozen=True)
class GINConfig:
    name: str = "gin-tu"
    n_layers: int = 5
    d_feat: int = 64
    d_hidden: int = 64
    n_classes: int = 16
    learnable_eps: bool = True
    graph_level: bool = False     # molecule regime: per-graph readout
    partitioned_edges: bool = False  # edges pre-partitioned by dst shard


class GIN(nn.Module):
    """``layers`` (each ``w1``, ``b1``, ``w2``, ``b2``, ``ln``, ``eps``) and
    ``head [d_hidden, n_classes]``, under ``repro``'s tree keys."""

    def __init__(self, cfg: GINConfig, tree: dict):
        super().__init__()
        self.cfg = cfg
        _tree.fill(self, tree)

    def forward(self, feats, src, dst):
        if feats.dim() == 3:
            return forward_batched_graphs(self, feats, src, dst, self.cfg)
        return forward_full_graph(self, feats, src, dst, self.cfg)

    def n_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def param_tree(self) -> dict:
        """The parameters in ``repro``'s tree."""
        return _tree.to_tree(self)


def init_gin(generator: torch.Generator, cfg: GINConfig,
             device="cuda") -> GIN:
    """Random weights drawn from ``generator`` on its own device, placed on
    ``device``."""
    dev = generator.device

    def normal(shape, scale):
        return torch.randn(shape, generator=generator, device=dev) * scale

    layers = []
    d_in = cfg.d_feat
    for _ in range(cfg.n_layers):
        layers.append({
            "w1": normal((d_in, cfg.d_hidden), d_in ** -0.5),
            "b1": torch.zeros((cfg.d_hidden,), device=dev),
            "w2": normal((cfg.d_hidden, cfg.d_hidden), cfg.d_hidden ** -0.5),
            "b2": torch.zeros((cfg.d_hidden,), device=dev),
            "ln": torch.ones((cfg.d_hidden,), device=dev),
            "eps": torch.zeros((), device=dev),
        })
        d_in = cfg.d_hidden
    tree = {"layers": layers,
            "head": normal((cfg.d_hidden, cfg.n_classes),
                           cfg.d_hidden ** -0.5)}
    return GIN(cfg, tree).to(device)


def _aggregate(h, src, dst, n_nodes):
    """Sum the messages ``h[src]`` into their ``dst`` rows; an edge with a
    ``-1`` end adds nothing.  One ``[E, d]`` buffer: the gather, masked in
    place."""
    valid = (src >= 0) & (dst >= 0)
    msg = h[torch.where(valid, src, 0)]
    msg.mul_(valid[:, None])
    out = torch.zeros((n_nodes, h.shape[1]), dtype=h.dtype, device=h.device)
    return out.index_add_(0, torch.where(valid, dst, 0), msg)


def _layer(lp, h, agg, eps_on: bool):
    x = (1.0 + lp.eps) * h + agg if eps_on else h + agg
    x = torch.relu(x @ lp.w1 + lp.b1)
    x = x @ lp.w2 + lp.b2
    # stateless LayerNorm in place of GIN's BatchNorm
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + 1e-5) * lp.ln
    return torch.relu(x)


def forward_full_graph(params: GIN, feats, src, dst, cfg: GINConfig):
    """feats [N, d_feat]; src/dst int[E] (-1 padded). Node logits [N, C].
    With ``cfg.partitioned_edges`` the edges are in the layout of
    ``partition_edges_by_dst``; on one device that sums the same messages
    into the same rows
    (``repro``'s single-device arm of ``_aggregate_partitioned`` is
    ``_aggregate``'s)."""
    n = feats.shape[0]
    h = feats
    for lp in params.layers:
        h = _layer(lp, h, _aggregate(h, src, dst, n), cfg.learnable_eps)
    return h @ params.head


def forward_batched_graphs(params: GIN, feats, src, dst, cfg: GINConfig):
    """Dense small-graph batch: feats [G, Nn, d], src/dst [G, Ne] (-1 pad).
    Returns graph logits [G, C] (sum readout).  The G graphs are one graph
    of G·Nn nodes: graph g's node ids offset by g·Nn."""
    G, nn_, _ = feats.shape
    off = (torch.arange(G, device=feats.device) * nn_)[:, None]
    valid = (src >= 0) & (dst >= 0)
    gsrc = torch.where(valid, src + off, -1).reshape(-1)
    gdst = torch.where(valid, dst + off, -1).reshape(-1)
    h = feats.reshape(G * nn_, -1)
    for lp in params.layers:
        h = _layer(lp, h, _aggregate(h, gsrc, gdst, G * nn_),
                   cfg.learnable_eps)
    return h.reshape(G, nn_, -1).sum(dim=1) @ params.head


def _nll(logits, labels):
    logp = F.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, 1, labels.long()[:, None])[:, 0]


def loss_full_graph(params: GIN, batch, cfg: GINConfig):
    """batch: feats [N,d], src/dst [E], labels [N], label_mask [N] ->
    (masked mean nll, {"acc"})."""
    logits = forward_full_graph(params, batch["feats"], batch["src"],
                                batch["dst"], cfg)
    nll = _nll(logits, batch["labels"])
    m = batch["label_mask"]
    n = torch.clamp_min(m.sum(), 1)
    loss = (nll * m).sum() / n
    acc = ((logits.argmax(-1) == batch["labels"]) * m).sum() / n
    return loss, {"acc": acc}


def loss_batched_graphs(params: GIN, batch, cfg: GINConfig):
    """batch: feats [G,Nn,d], src/dst [G,Ne], labels [G] -> (mean nll,
    {"acc"})."""
    logits = forward_batched_graphs(params, batch["feats"], batch["src"],
                                    batch["dst"], cfg)
    nll = _nll(logits, batch["labels"])
    acc = (logits.argmax(-1) == batch["labels"]).float().mean()
    return nll.mean(), {"acc": acc}


def params_from_numpy(tree: dict, cfg: GINConfig, device="cuda") -> GIN:
    """The model of ``repro``'s ``init_gin`` parameter tree, given as numpy
    arrays (float32)."""
    return GIN(cfg, _tree.from_numpy_tree(tree)).to(device)


def params_to_numpy(model: GIN) -> dict:
    """The inverse of :func:`params_from_numpy`: ``repro``'s tree layout."""
    return _tree.to_numpy_tree(model)
