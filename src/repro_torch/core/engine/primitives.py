"""Shape-static primitives shared by every engine phase (plain PyTorch).

Vectorized CSR binary search / child lookup and the dedup-compaction that
keeps locus frontiers canonical — the counterparts of
``repro.core.engine.primitives``.  Values are int32; index arithmetic runs
in int64 and is cast back at the boundary.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.engine.structs import INT_MAX, NEG_ONE


def resolve_sub(cfg, sub):
    """Substrate threading helper: explicit ``sub`` wins, else the registry
    entry named by ``cfg.substrate`` (late import: the registry module
    imports this one)."""
    if sub is not None:
        return sub
    from repro_torch.core.engine.substrate import get_substrate
    return get_substrate(cfg.substrate)


def iters_for(n: int) -> int:
    return max(1, int(math.ceil(math.log2(max(n, 1) + 1))))


def lower_bound(arr: torch.Tensor, lo, hi, x, iters: int):
    """First index in [lo, hi) with arr[idx] >= x (vectorized, fixed
    iters).  lo/hi/x broadcast together; returns int64."""
    size = max(int(arr.shape[0]), 1)
    lo = lo.long()
    hi = hi.long()
    for _ in range(iters):
        cont = lo < hi
        mid = (lo + hi) >> 1
        v = arr[mid.clamp(0, size - 1)]
        go_right = v < x
        lo = torch.where(cont & go_right, mid + 1, lo)
        hi = torch.where(cont & ~go_right, mid, hi)
    return lo


def csr_child_lookup(ptr, chars, children, nodes, ch, iters: int):
    """children[nodes] labelled ch via binary search in each CSR row; -1 if
    absent.  nodes may contain -1 entries (propagated); ch broadcasts."""
    shape = torch.broadcast_shapes(nodes.shape, torch.as_tensor(ch).shape)
    if int(chars.shape[0]) == 0:
        return torch.full(shape, NEG_ONE, dtype=torch.int32,
                          device=nodes.device)
    valid = nodes >= 0
    n = torch.where(valid, nodes, 0).long()
    lo = ptr[n]
    hi = ptr[n + 1]
    pos = lower_bound(chars, lo, hi, ch, iters)
    size = max(int(chars.shape[0]), 1)
    posc = pos.clamp(0, size - 1)
    found = (pos < hi) & (chars[posc] == ch) & valid & (ch >= 0)
    return torch.where(found, children[posc], NEG_ONE).to(torch.int32)


def dedup_pad(vec: torch.Tensor, width: int):
    """Unique ids along the last axis (-1 = empty), first ``width`` kept in
    ascending id order.

    Returns (out[..., width] int32 with -1 pad, n_dropped[...] int32), where
    n_dropped = max(#unique - width, 0)."""
    big = torch.where(vec < 0, INT_MAX, vec.to(torch.int64))
    s = torch.sort(big, dim=-1).values
    keep = torch.ones_like(s, dtype=torch.bool)
    keep[..., 1:] = s[..., 1:] != s[..., :-1]
    keep &= s != INT_MAX
    rank = torch.cumsum(keep.to(torch.int64), dim=-1) - 1
    n_uniq = keep.sum(dim=-1)
    dst = torch.where(keep & (rank < width), rank, width)
    out = torch.full(tuple(s.shape[:-1]) + (width + 1,), NEG_ONE,
                     dtype=torch.int64, device=vec.device)
    out.scatter_(-1, dst, torch.where(keep, s, NEG_ONE))
    out = out[..., :width].to(torch.int32)
    dropped = (n_uniq - width).clamp(min=0).to(torch.int32)
    return out, dropped
