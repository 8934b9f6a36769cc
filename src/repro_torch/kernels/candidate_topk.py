"""CUDA kernel: fused candidate scoring + top-k.

Replaces ``repro/kernels/candidate_topk.py:51`` ``candidate_topk``: one
float32 query [D] against candidates [C, D], the k best dot products,
score-descending, ties to the lower id (``lax.top_k``'s order, which is
``repro.kernels.ref.candidate_topk_ref``'s contract); slots past C hold
``(-3.0e38, -1)``.  Pass 1 (``csrc/candidate_topk.cu``) gives each slice
of ``block_c`` candidates a block that scores it in float32 from
shared-memory tiles and keeps its top-k; pass 2 merges the slices' lists
a few at a time until one is left (blocks run in no order, so nothing
carries across them as the TPU grid's running top-k does).

Bound on the H100: the bytes of reading the candidates once, C·D·4.

:func:`candidate_topk` launches the kernels for CUDA tensors and answers
CPU tensors with :func:`candidate_topk_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

#: kernel launches (each :func:`candidate_topk` call on CUDA tensors adds
#: one, whatever the number of merge passes) and plain-version calls
launches = 0
plain_calls = 0

NEG_FILL = -3.0e38
_THREADS = 256
_MERGE_THREADS = 512
#: keys one merge block sorts (64 KB of shared memory)
_MERGE_KEYS = 8192

_V, _I = ctypes.c_void_p, ctypes.c_int


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def candidate_topk_plain(query: torch.Tensor, candidates: torch.Tensor,
                         k: int, block_c: int = 1024):
    """The plain version: every score, then a stable descending sort (ties
    to the lower id); ``block_c`` does not change the answer."""
    global plain_calls
    plain_calls += 1
    scores = candidates.float() @ query.float()
    order = torch.sort(scores, descending=True, stable=True).indices[:k]
    top_s = torch.full((k,), NEG_FILL, dtype=torch.float32,
                       device=query.device)
    top_i = torch.full((k,), -1, dtype=torch.int32, device=query.device)
    n = int(order.shape[0])
    top_s[:n] = scores[order]
    top_i[:n] = order.to(torch.int32)
    return top_s, top_i


def launch_plan(n_cands: int, dim: int, k: int, block_c: int):
    """(slice width, sort width, tile rows, shared bytes) of pass 1 and
    the merge group of pass 2; raises on shapes past what a block's
    shared memory holds."""
    block_c = max(1, min(block_c, n_cands))
    sort_n = _pow2(block_c)
    fixed = 8 * sort_n + 4 * dim
    tile_rows = min(_THREADS, (_build.MAX_SHARED_BYTES - fixed)
                    // (4 * (dim + 1)))
    if tile_rows < 1 or k > _MERGE_KEYS // 2:
        raise ValueError(
            f"candidate_topk: block_c={block_c}, D={dim}, k={k} need "
            f"{fixed + 4 * (dim + 1)} B of shared memory per block and "
            f"k <= {_MERGE_KEYS // 2}; a block has "
            f"{_build.MAX_SHARED_BYTES} B")
    shared = fixed + 4 * (dim + 1) * tile_rows
    group = max(2, _MERGE_KEYS // _pow2(k))
    return block_c, sort_n, tile_rows, shared, group


def _lib():
    lib = _build.library("candidate_topk")
    score, merge = lib.candidate_score_launch, lib.candidate_merge_launch
    if score.argtypes is None:
        score.argtypes = [_V, _V] + [_I] * 9 + [_V, _V]
        score.restype = _I
        merge.argtypes = [_V] + [_I] * 7 + [_V, _V, _V, _I, _V]
        merge.restype = _I
    return score, merge


def candidate_topk(query: torch.Tensor, candidates: torch.Tensor, k: int,
                   block_c: int = 1024):
    """query f32[D], candidates f32[C, D] -> (scores f32[k], ids int32[k]):
    the kernels on CUDA tensors, the plain version on CPU tensors."""
    global launches
    if query.device.type == "cpu":
        return candidate_topk_plain(query, candidates, k, block_c)
    dev = query.device
    name = "candidate_topk"
    _build.check_tensors(name, dev, (torch.float32,), query=query,
                         candidates=candidates)
    if candidates.dim() != 2 or query.shape != candidates.shape[1:]:
        raise ValueError(f"{name}: query {tuple(query.shape)} and "
                         f"candidates {tuple(candidates.shape)} must be [D] "
                         "and [C, D]")
    C, D = candidates.shape
    if k < 1 or C < 1 or C >= 2**31:
        raise ValueError(f"{name}: needs k >= 1 and 1 <= C < 2**31; got "
                         f"k={k}, C={C}")
    block_c, sort_n, tile_rows, shared, group = launch_plan(C, D, k, block_c)
    n_lists = -(-C // block_c)
    keys = torch.empty(n_lists * k, dtype=torch.int64, device=dev)
    out_s = torch.empty(k, dtype=torch.float32, device=dev)
    out_i = torch.empty(k, dtype=torch.int32, device=dev)
    p, stream = _build.ptr, _build.stream(dev)
    score, merge = _lib()
    _build.check_launch(name, score(
        p(query), p(candidates), C, D, block_c, tile_rows, sort_n, k,
        n_lists, _THREADS, shared, p(keys), stream))
    while True:
        g = min(group, n_lists)
        n_out = -(-n_lists // g)
        final = int(n_out == 1)
        nxt = keys if final else torch.empty(n_out * k, dtype=torch.int64,
                                             device=dev)
        m_sort = _pow2(g * k)
        _build.check_launch(name, merge(
            p(keys), n_lists, k, g, m_sort, n_out, _MERGE_THREADS,
            8 * m_sort, p(nxt), p(out_s), p(out_i), final, stream))
        if final:
            break
        keys, n_lists = nxt, n_out
    launches += 1
    return out_s, out_i
