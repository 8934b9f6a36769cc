"""CUDA kernel: top-k selection with a payload.

Replaces ``repro/kernels/topk_select.py:37`` ``topk_select``.  One thread
block per row takes k rounds of block-wide argmax over a
(score, lower-column) order key (``csrc/topk_select.cu``); ties go to the
lower candidate index, as in ``lax.top_k``.  It serves the substrate's
``topk_with_payload``: the rule-free cached phase 2 today, the overlay
and shard merges later.

Bound on the H100: the k dependent block reductions of a row, not the
bytes — a row is read from device memory once and from L1 after that.

:func:`topk_select` launches the kernel for CUDA tensors and answers CPU
tensors with :func:`topk_select_plain`, the plain PyTorch version
(:func:`repro_torch.core.engine.cached.select_topk`).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.engine import cached
from repro_torch.kernels import _build

#: kernel launches (each :func:`topk_select` call on CUDA tensors adds one)
launches = 0

#: the plain version: a stable descending sort of each row
topk_select_plain = cached.select_topk

_V, _I = ctypes.c_void_p, ctypes.c_int


def launch_threads(C: int) -> int:
    """Threads of one block: a warp multiple, at most 256, no more than
    the row needs."""
    return min(256, max(32, (C + 31) // 32 * 32))


def _lib():
    fn = _build.library("topk_select").topk_select_launch
    if fn.argtypes is None:
        fn.argtypes = [_V, _V, _I, _I, _I, _I, _V, _V, _V]
        fn.restype = _I
    return fn


def topk_select(scores: torch.Tensor, payload: torch.Tensor, k: int):
    """scores/payload int32[B, C] -> (top_s[B, k], top_p[B, k]): the kernel
    on CUDA tensors, the plain version on CPU tensors."""
    global launches
    if scores.device.type == "cpu":
        return topk_select_plain(scores, payload, k)
    dev = scores.device
    _build.check_tensors("topk_select", dev, scores=scores, payload=payload)
    _build.check_dtype("topk_select", "scores", scores, torch.int32)
    _build.check_dtype("topk_select", "payload", payload, torch.int32)
    if scores.dim() != 2 or payload.shape != scores.shape:
        raise ValueError(f"topk_select: scores {tuple(scores.shape)} and "
                         f"payload {tuple(payload.shape)} must be one "
                         "[B, C] shape")
    B, C = scores.shape
    if not 1 <= k <= C:
        raise ValueError(f"topk_select: needs 1 <= k <= C; got k={k}, C={C}")
    out_s = torch.empty((B, k), dtype=torch.int32, device=dev)
    out_p = torch.empty((B, k), dtype=torch.int32, device=dev)
    p = _build.ptr
    err = _lib()(p(scores), p(payload), B, C, k, launch_threads(C),
                 p(out_s), p(out_p), _build.stream(dev))
    _build.check_launch("topk_select", err)
    launches += 1
    return out_s, out_p
