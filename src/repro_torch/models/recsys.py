"""RecSys models: DLRM (dot interaction), DIN (target attention), SASRec
(self-attentive sequential), MIND (multi-interest capsule routing) —
``repro``'s ``models/recsys.py`` on one device: serving and the losses.

Each arch is an ``nn.Module`` (:class:`DLRM`, :class:`DIN`,
:class:`SASRec`, :class:`MIND`) that keeps ``repro``'s parameter tree
under its keys; the functions keep ``repro``'s names and take the module
where ``repro`` takes its tree.  :func:`params_from_numpy` builds a model
from ``repro``'s tree, so both packages compute one function.

Two of the port's kernels are on this path, launched on CUDA tensors and
answered by their plain versions on CPU ones:

- DIN's pooled history, a weighted bag over ``hist``, is
  ``kernels.embedding_bag.embedding_bag_dense`` (it skips the ``-1`` pads,
  whose weight is 0); in training its backward kernel gives the item table
  and the attention weights their gradients through the bag (a pad sends
  none, as in ``repro``, where the pad's row ``items[V-1]`` is weighted
  by a 0 that the mask makes);
- :func:`retrieval_topk` scores a ``[B, D]`` user row by row with
  ``kernels.candidate_topk.candidate_topk`` (one launch a row).  MIND's
  ``[B, K, D]`` interests take a max over K, which no kernel computes (in
  ``repro`` either): one matmul, ``amax`` and a stable descending sort,
  ties to the lower id as ``lax.top_k`` gives them, on both devices.

The losses return ``repro``'s (loss, metrics) pairs and are
differentiated by autograd.  The mesh arms (``repro``'s ``shard_map``
lookups and ``all_gather`` merge) are ROADMAP.md §1 item 12.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.candidate_topk import candidate_topk
from repro_torch.kernels.embedding_bag import embedding_bag_dense
from repro_torch.models import _tree

# ---------------------------------------------------------------------------
# lookups and retrieval (the single-device arms)
# ---------------------------------------------------------------------------


def embedding_lookup(table, ids):
    """table [V, D]; ids int[...] -> [..., D].  A ``-1`` reads the last row,
    as ``jnp.take`` does."""
    return table[ids]


def stacked_embedding_lookup(tables, ids):
    """tables [F, V, D]; ids int[B, F] -> [B, F, D] (row ``ids[b, f]`` of
    table f)."""
    f = torch.arange(tables.shape[0], device=tables.device)
    return tables[f[None, :], ids]


def retrieval_topk(user, cand, k: int):
    """user [B, D] (or [B, K, D] multi-interest); cand [C, D].  Returns
    (scores f32[B, k], ids int32[B, k]), score-descending, ties to the
    lower id."""
    if not 1 <= k <= cand.shape[0]:
        raise ValueError(f"retrieval_topk: k={k} must be in [1, C="
                         f"{cand.shape[0]}]")
    if user.dim() == 2:
        user = user.contiguous()
        rows = [candidate_topk(u, cand, k) for u in user]
        return (torch.stack([s for s, _ in rows]),
                torch.stack([i for _, i in rows]))
    s = torch.matmul(user, cand.T).amax(dim=1)                    # [B, C]
    top = torch.sort(s, dim=1, descending=True, stable=True)
    return top.values[:, :k], top.indices[:, :k].to(torch.int32)


# ---------------------------------------------------------------------------
# the MLPs and the modules
# ---------------------------------------------------------------------------


def _normal(generator: torch.Generator, shape, scale) -> torch.Tensor:
    return torch.randn(shape, generator=generator,
                       device=generator.device) * scale


def _mlp_init(generator: torch.Generator, dims, scale=None) -> dict:
    dev = generator.device
    ws, bs = [], []
    for i in range(len(dims) - 1):
        ws.append(_normal(generator, (dims[i], dims[i + 1]),
                          scale or dims[i] ** -0.5))
        bs.append(torch.zeros((dims[i + 1],), device=dev))
    return {"w": ws, "b": bs}


def _mlp_apply(p, x, final_act=False):
    n = len(p.w)
    for i in range(n):
        x = x @ p.w[i] + p.b[i]
        if i < n - 1 or final_act:
            x = torch.relu(x)    # gradient 0 at 0, as jax.nn.relu's
    return x


def _bce(logit, label):
    """``repro``'s binary cross-entropy with logits, with its gradient at
    an exact zero logit (biases start at 0, so a row whose last hidden
    layer is all zero after the ReLU gives one): ``jnp.maximum(x, 0)``
    gives each side half, which ``torch.maximum`` does too, and
    ``jnp.abs`` gives +1, which the ``where`` below does (``torch.abs``
    gives 0)."""
    absl = torch.where(logit >= 0, logit, -logit)
    return torch.mean(torch.maximum(logit, torch.zeros_like(logit))
                      - logit * label + torch.log1p(torch.exp(-absl)))


class RecsysModel(nn.Module):
    """One arch's weights under ``repro``'s tree keys, and its config;
    ``forward(batch)`` is the arch's serving function (``repro``'s
    ``configs/cells.py`` ``_REC_FNS``: the logit for DLRM and DIN, the
    user embedding for SASRec and MIND)."""

    def __init__(self, cfg, tree: dict):
        super().__init__()
        self.cfg = cfg
        _tree.fill(self, tree)

    def n_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def param_tree(self) -> dict:
        """The parameters in ``repro``'s tree."""
        return _tree.to_tree(self)


# ---------------------------------------------------------------------------
# DLRM  [arXiv:1906.00091]
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DLRMConfig:
    name: str = "dlrm-rm2"
    n_dense: int = 13
    n_sparse: int = 26
    d_embed: int = 64
    vocab: int = 1_000_000
    bot_mlp: tuple = (512, 256, 64)
    top_mlp: tuple = (512, 512, 256, 1)


class DLRM(RecsysModel):
    """``tables [F, V, D]``, ``bot`` and ``top`` MLPs."""

    def forward(self, batch):
        return dlrm_forward(self, batch, self.cfg)


def init_dlrm(generator: torch.Generator, cfg: DLRMConfig,
              device="cuda") -> DLRM:
    """Random weights drawn from ``generator`` on its own device, placed on
    ``device``."""
    n_inter = (cfg.n_sparse + 1) * cfg.n_sparse // 2
    top_in = n_inter + cfg.bot_mlp[-1]
    tree = {
        "tables": _normal(generator, (cfg.n_sparse, cfg.vocab, cfg.d_embed),
                          cfg.d_embed ** -0.5),
        "bot": _mlp_init(generator, (cfg.n_dense,) + cfg.bot_mlp),
        "top": _mlp_init(generator, (top_in,) + cfg.top_mlp),
    }
    return DLRM(cfg, tree).to(device)


def dlrm_forward(params: DLRM, batch, cfg: DLRMConfig):
    """batch: dense f32[B, n_dense], sparse int[B, n_sparse] -> logit [B]."""
    d = _mlp_apply(params.bot, batch["dense"], final_act=True)    # [B, 64]
    e = stacked_embedding_lookup(params.tables, batch["sparse"])
    z = torch.cat([d[:, None, :], e], dim=1)                      # [B, 27, D]
    inter = torch.bmm(z, z.transpose(1, 2))
    n = z.shape[1]
    iu, ju = torch.triu_indices(n, n, offset=1, device=z.device)
    tri = inter[:, iu, ju]                         # [B, 351], row-major
    x = torch.cat([d, tri], dim=1)
    return _mlp_apply(params.top, x)[:, 0]


def dlrm_loss(params: DLRM, batch, cfg: DLRMConfig):
    logit = dlrm_forward(params, batch, cfg)
    loss = _bce(logit, batch["label"].float())
    return loss, {"logit_mean": logit.mean()}


def dlrm_user_embedding(params: DLRM, batch, cfg: DLRMConfig):
    return _mlp_apply(params.bot, batch["dense"], final_act=True)


# ---------------------------------------------------------------------------
# DIN  [arXiv:1706.06978]
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DINConfig:
    name: str = "din"
    d_embed: int = 18
    seq_len: int = 100
    vocab: int = 1_000_000
    attn_mlp: tuple = (80, 40)
    mlp: tuple = (200, 80)


class DIN(RecsysModel):
    """``items [V, D]``, the ``attn`` and ``out`` MLPs."""

    def forward(self, batch):
        return din_forward(self, batch, self.cfg)


def init_din(generator: torch.Generator, cfg: DINConfig,
             device="cuda") -> DIN:
    d = cfg.d_embed
    tree = {
        "items": _normal(generator, (cfg.vocab, d), d ** -0.5),
        "attn": _mlp_init(generator, (4 * d,) + cfg.attn_mlp + (1,)),
        "out": _mlp_init(generator, (3 * d,) + cfg.mlp + (1,)),
    }
    return DIN(cfg, tree).to(device)


def din_history_weights(params: DIN, batch, cfg: DINConfig):
    """The target attention: (the pooled history's bag, int32 [B, T] with
    -1 pads, its weights [B, T], 0 at the pads; the target embedding
    [B, D])."""
    hist = batch["hist"]
    e_h = embedding_lookup(params.items, hist)                    # [B, T, D]
    e_t = embedding_lookup(params.items, batch["target"])         # [B, D]
    et = e_t[:, None, :].expand_as(e_h)
    a_in = torch.cat([e_h, et, e_h - et, e_h * et], dim=-1)
    a = _mlp_apply(params.attn, a_in)[..., 0]                     # [B, T]
    mask = hist >= 0
    a = torch.where(mask, a, -1e30)
    a = torch.sigmoid(a) * mask                                   # no softmax
    return hist.to(torch.int32).contiguous(), a.contiguous(), e_t


def din_user_embedding(params: DIN, batch, cfg: DINConfig):
    """batch: hist int[B, T] (-1 pad), target int[B] -> (user [B, D],
    target embedding [B, D]).  The user is the bag of the history's rows
    weighted by the attention, repro's ``(a[..., None] * e_h).sum(1)``."""
    bag, a, e_t = din_history_weights(params, batch, cfg)
    return embedding_bag_dense(params.items, bag, a, "sum"), e_t


def din_forward(params: DIN, batch, cfg: DINConfig):
    user, e_t = din_user_embedding(params, batch, cfg)
    x = torch.cat([user, e_t, user * e_t], dim=-1)
    return _mlp_apply(params.out, x)[:, 0]


def din_loss(params: DIN, batch, cfg: DINConfig):
    logit = din_forward(params, batch, cfg)
    return _bce(logit, batch["label"].float()), {}


# ---------------------------------------------------------------------------
# SASRec  [arXiv:1808.09781]
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SASRecConfig:
    name: str = "sasrec"
    d_embed: int = 50
    n_blocks: int = 2
    n_heads: int = 1
    seq_len: int = 50
    vocab: int = 1_000_000


class SASRec(RecsysModel):
    """``items [V, D]``, ``pos [T, D]`` and ``blocks``."""

    def forward(self, batch):
        return sasrec_user_embedding(self, batch, self.cfg)


def init_sasrec(generator: torch.Generator, cfg: SASRecConfig,
                device="cuda") -> SASRec:
    d = cfg.d_embed
    dev = generator.device
    s = d ** -0.5
    tree = {"items": _normal(generator, (cfg.vocab, d), s),
            "pos": _normal(generator, (cfg.seq_len, d), 0.02),
            "blocks": []}
    for _ in range(cfg.n_blocks):
        tree["blocks"].append({
            "wqkv": _normal(generator, (d, 3 * d), s),
            "wo": _normal(generator, (d, d), s),
            "ln1": torch.ones((d,), device=dev),
            "ln2": torch.ones((d,), device=dev),
            "w1": _normal(generator, (d, d), s),
            "b1": torch.zeros((d,), device=dev),
            "w2": _normal(generator, (d, d), s),
            "b2": torch.zeros((d,), device=dev),
        })
    return SASRec(cfg, tree).to(device)


def _ln(x, w):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-6) * w


def sasrec_hidden(params: SASRec, hist, cfg: SASRecConfig):
    """hist int[B, T] (-1 pad) -> hidden states [B, T, D]."""
    T = hist.shape[1]
    d = cfg.d_embed
    mask = hist >= 0
    h = embedding_lookup(params.items, hist.clamp(min=0)) * math.sqrt(d)
    h = h + params.pos[None, :T]
    h = h * mask[..., None]
    causal = torch.tril(torch.ones((T, T), dtype=torch.bool,
                                   device=hist.device))
    keep = causal[None] & mask[:, None, :]
    for blk in params.blocks:
        q, k, v = torch.split(_ln(h, blk.ln1) @ blk.wqkv, d, dim=-1)
        s = (q @ k.transpose(1, 2)) / math.sqrt(d)
        # -1e30, not -inf: a fully masked row is uniform, as in repro
        att = torch.softmax(torch.where(keep, s, -1e30), dim=-1)
        h = h + (att @ v) @ blk.wo
        hn = _ln(h, blk.ln2)
        h = h + torch.relu(hn @ blk.w1 + blk.b1) @ blk.w2 + blk.b2
        h = h * mask[..., None]
    return h


def sasrec_loss(params: SASRec, batch, cfg: SASRecConfig):
    """batch: hist [B,T], pos [B,T], neg [B,T] (next-item targets +
    negatives, -1 padded)."""
    h = sasrec_hidden(params, batch["hist"], cfg)
    e_p = embedding_lookup(params.items, batch["pos"].clamp(min=0))
    e_n = embedding_lookup(params.items, batch["neg"].clamp(min=0))
    m = (batch["pos"] >= 0).float()
    lp = (h * e_p).sum(dim=-1)
    ln_ = (h * e_n).sum(dim=-1)
    loss = -(F.logsigmoid(lp) + F.logsigmoid(-ln_)) * m
    return loss.sum() / torch.clamp_min(m.sum(), 1), {}


def sasrec_user_embedding(params: SASRec, batch, cfg: SASRecConfig):
    """The last position's hidden state [B, D] (zero where the history is
    padded there, as in repro)."""
    return sasrec_hidden(params, batch["hist"], cfg)[:, -1]


# ---------------------------------------------------------------------------
# MIND  [arXiv:1904.08030]
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MINDConfig:
    name: str = "mind"
    d_embed: int = 64
    n_interests: int = 4
    capsule_iters: int = 3
    seq_len: int = 50
    vocab: int = 1_000_000
    pow_p: float = 2.0


class MIND(RecsysModel):
    """``items [V, D]``, the shared bilinear ``S [D, D]`` and
    ``b_init [T, K]``."""

    def forward(self, batch):
        return mind_user_embedding(self, batch, self.cfg)


def init_mind(generator: torch.Generator, cfg: MINDConfig,
              device="cuda") -> MIND:
    d = cfg.d_embed
    tree = {"items": _normal(generator, (cfg.vocab, d), d ** -0.5),
            "S": _normal(generator, (d, d), d ** -0.5),
            "b_init": _normal(generator, (cfg.seq_len, cfg.n_interests),
                              1.0)}
    return MIND(cfg, tree).to(device)


def _squash(x):
    n2 = (x * x).sum(dim=-1, keepdim=True)
    return (n2 / (1 + n2)) * x * torch.rsqrt(n2 + 1e-9)


def mind_interests(params: MIND, hist, cfg: MINDConfig):
    """Dynamic routing (behavior -> interest capsules).
    hist [B,T] -> [B,K,D]."""
    B, T = hist.shape
    mask = (hist >= 0)[..., None]
    e = embedding_lookup(params.items, hist.clamp(min=0))        # [B,T,D]
    eh = e @ params.S                                             # [B,T,D]
    b = params.b_init[None, :T].expand(B, -1, -1)                 # [B,T,K]
    for it in range(cfg.capsule_iters):
        w = torch.softmax(b, dim=-1) * mask                       # [B,T,K]
        c = _squash(w.transpose(1, 2) @ eh)                       # [B,K,D]
        if it < cfg.capsule_iters - 1:
            b = b + eh @ c.transpose(1, 2)
    return c


def mind_loss(params: MIND, batch, cfg: MINDConfig):
    """batch: hist [B,T], target [B], neg [B, N]."""
    caps = mind_interests(params, batch["hist"], cfg)             # [B,K,D]
    e_t = embedding_lookup(params.items, batch["target"])         # [B,D]
    # label-aware attention over interests
    att = torch.softmax(cfg.pow_p * (caps @ e_t[:, :, None])[..., 0],
                        dim=-1)                                   # [B,K]
    u = (att[:, None, :] @ caps)[:, 0]                            # [B,D]
    e_n = embedding_lookup(params.items, batch["neg"])            # [B,N,D]
    lp = (u * e_t).sum(dim=-1)
    ln_ = (e_n @ u[:, :, None])[..., 0]
    loss = -(F.logsigmoid(lp).mean() + F.logsigmoid(-ln_).mean())
    return loss, {}


def mind_user_embedding(params: MIND, batch, cfg: MINDConfig):
    return mind_interests(params, batch["hist"], cfg)             # [B,K,D]


# ---------------------------------------------------------------------------
# repro's trees
# ---------------------------------------------------------------------------

class Arch(NamedTuple):
    """One arch's module and the functions of ``repro``'s
    ``configs/cells.py`` ``_REC_FNS``."""
    module: type
    init: Callable
    forward: Callable          # the serving forward
    user: Callable             # the user embedding
    table: str                 # the candidate table's key
    loss: Callable             # the training loss


#: per config type, its :class:`Arch`
ARCHS = {
    DLRMConfig: Arch(DLRM, init_dlrm, dlrm_forward, dlrm_user_embedding,
                     "tables", dlrm_loss),
    DINConfig: Arch(DIN, init_din, din_forward,
                    lambda p, b, c: din_user_embedding(p, b, c)[0], "items",
                    din_loss),
    SASRecConfig: Arch(SASRec, init_sasrec, sasrec_user_embedding,
                       sasrec_user_embedding, "items", sasrec_loss),
    MINDConfig: Arch(MIND, init_mind, mind_user_embedding,
                     mind_user_embedding, "items", mind_loss),
}


def candidates(params: RecsysModel, n: int):
    """The retrieval cell's candidates: the first ``n`` rows of the arch's
    item table (DLRM: of table 0), as ``repro``'s retrieval cell takes
    them."""
    cand = getattr(params, ARCHS[type(params.cfg)].table)
    return (cand[0] if cand.dim() == 3 else cand)[:n]


def params_from_numpy(tree: dict, cfg, device="cuda") -> RecsysModel:
    """The model of ``repro``'s ``init_*`` parameter tree for ``cfg``, given
    as numpy arrays (float32)."""
    return ARCHS[type(cfg)].module(cfg, _tree.from_numpy_tree(tree)).to(
        device)


def params_to_numpy(model: RecsysModel) -> dict:
    """The inverse of :func:`params_from_numpy`: ``repro``'s tree layout."""
    return _tree.to_numpy_tree(model)
