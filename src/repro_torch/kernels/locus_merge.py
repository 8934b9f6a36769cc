"""CUDA kernel: the cached phase 2 — per-node top-K gather + merge.

Replaces ``repro/kernels/locus_merge.py:53`` ``locus_topk_merge`` and,
for the packed layout, the decode that ``repro/kernels/ops.py:285``
``cached_topk_merge_packed`` runs around it.  One thread block per query
(``csrc/locus_merge.cu``) gathers the F*K candidates of its loci into
shared memory — loci-major, K-minor, -1 where empty; on a packed index
through each locus's chain-representative rank in ``c_ids``, decoding
only the u16 rows it reads — and takes k rounds of block-wide argmax,
ties to the first maximum.  ``k >= F*K`` sorts the whole union and pads
with -1, inside the kernel.

Bound on the H100: the k dependent block reductions, not bandwidth — a
query reads its F cache rows once.

:func:`locus_topk_merge` launches the kernel for CUDA tensors and answers
CPU tensors with :func:`locus_merge_plain`, the plain PyTorch version
(:func:`repro_torch.core.engine.cached.cached_topk`).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.engine import cached
from repro_torch.core.engine import packed as pk
from repro_torch.core.engine.structs import DeviceTrie
from repro_torch.kernels import _build

#: kernel launches (each :func:`locus_topk_merge` call on CUDA tensors
#: adds one)
launches = 0

#: the plain version: gather + stable sort of the candidate union
locus_merge_plain = cached.cached_topk

_V, _I = ctypes.c_void_p, ctypes.c_int


def launch_shape(F: int, K: int):
    """(threads, shared bytes) of one block; raises when the staged
    candidates exceed what a block may have."""
    C = F * K
    threads = min(256, max(32, (C + 31) // 32 * 32))
    shared = 4 * (2 * C + F)
    if shared > _build.MAX_SHARED_BYTES:
        raise ValueError(
            f"locus_topk_merge: F={F}, K={K} need {shared} bytes of shared "
            f"memory per block, more than the {_build.MAX_SHARED_BYTES} a "
            "block may have")
    return threads, shared


def _lib():
    fn = _build.library("locus_merge").locus_merge_launch
    if fn.argtypes is None:
        fn.argtypes = ([_I, _I, _V, _V, _I, _I, _V, _V, _I, _V]
                       + [_I] * 5 + [_V] * 3)
        fn.restype = _I
    return fn


def locus_topk_merge(t: DeviceTrie, loci: torch.Tensor, k: int):
    """loci int32[B, F] -> (scores[B, k], sids[B, k]) from the index's
    cache, either layout: the kernel on CUDA tensors, the plain version
    on CPU tensors."""
    global launches
    if loci.device.type == "cpu":
        return locus_merge_plain(t, loci, k)
    dev = loci.device
    name = "locus_topk_merge"
    B, F = loci.shape
    if k < 1:
        raise ValueError(f"{name}: k must be >= 1, got {k}")
    _build.check_tensors(name, dev, loci=loci)
    _build.check_dtype(name, "loci", loci, torch.int32)
    packed = pk.is_packed(t)
    if packed:
        score, sid, base, c_ids = t.pc_score, t.pc_sid, t.pc_base, t.c_ids
        _build.check_tensors(name, dev, _build.PACKED_DTYPES,
                             pc_score=score, pc_sid=sid)
        _build.check_tensors(name, dev, pc_base=base, c_ids=c_ids)
        _build.check_dtype(name, "pc_base", base, torch.int32)
        _build.check_dtype(name, "c_ids", c_ids, torch.int32)
        score_u16 = _build.is_u16(name, "pc_score", score)
        sid_u16 = _build.is_u16(name, "pc_sid", sid)
        n_c = int(c_ids.shape[0])
    else:
        score, sid = t.topk_score, t.topk_sid
        _build.check_tensors(name, dev, topk_score=score, topk_sid=sid)
        _build.check_dtype(name, "topk_score", score, torch.int32)
        _build.check_dtype(name, "topk_sid", sid, torch.int32)
        base = c_ids = loci           # unread in the dense layout
        score_u16 = sid_u16 = n_c = 0
    K = int(score.shape[1])
    threads, shared = launch_shape(F, K)
    out_s = torch.empty((B, k), dtype=torch.int32, device=dev)
    out_p = torch.empty((B, k), dtype=torch.int32, device=dev)
    p = _build.ptr
    err = _lib()(int(packed), K, p(score), p(sid), score_u16, sid_u16,
                 p(base), p(c_ids), n_c, p(loci), B, F, k, threads, shared,
                 p(out_s), p(out_p), _build.stream(dev))
    _build.check_launch(name, err)
    launches += 1
    return out_s, out_p
