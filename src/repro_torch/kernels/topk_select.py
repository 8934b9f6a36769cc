"""CUDA kernel: top-k selection with a payload.

Replaces ``repro/kernels/topk_select.py:37`` ``topk_select``.  k rounds of
argmax over a (score, lower-column) order key (``csrc/topk_select.cu``);
ties go to the lower candidate index, as in ``lax.top_k``, and rows may
be in any order.  It serves the substrate's ``topk_with_payload``: the
rule-free cached phase 2 today, the overlay and shard merges later.  Up
to C = 1,024 columns a warp takes a row with the keys in registers
(:func:`launch_plan`); wider rows take a block each.

Bound on the H100: the k dependent rounds of a row and, end to end, the
host's launch — a row is read from device memory once.  So a call checks
its two row inputs, allocates both outputs at once and makes one ctypes
call.

:func:`topk_select` launches the kernel for CUDA tensors and answers CPU
tensors with :func:`topk_select_plain`, the plain PyTorch version
(:func:`repro_torch.core.engine.cached.select_topk`).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.engine import cached
from repro_torch.kernels import _build

#: kernel launches (each :func:`topk_select` call on CUDA tensors adds one)
launches = 0

#: the plain version: a stable descending sort of each row
topk_select_plain = cached.select_topk

#: keys a lane of the warp path: the template instances of the kernels
WARP_KEYS = (1, 2, 4, 8, 16, 32)
#: the H100 SXM's streaming multiprocessors (the plan's default)
SMS = 132
#: warps a block at most on the warp path
MAX_WARPS = 8

_V, _I = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def launch_plan(C: int, B: int, sms: int = SMS):
    """(keys a lane, threads) of a launch over B rows of C candidates.
    The warp path, up to 32 * 32 = 1,024 candidates: the fewest keys a
    lane (a power of two) that hold a row, and the fewest warps a block
    (at most ``MAX_WARPS``) that still give every SM at most one block.
    Wider rows take the block path: 0 keys a lane and a block of up to
    256 threads a row."""
    keys = next((r for r in WARP_KEYS if 32 * r >= C), 0)
    if keys:
        warps = min(MAX_WARPS, max(1, -(-B // sms)))
        return keys, 32 * warps
    return 0, min(256, (C + 31) // 32 * 32)


_launch = None


def _lib():
    global _launch
    if _launch is None:
        fn = _build.library("topk_select").topk_select_launch
        fn.argtypes = [_V, _V] + [_I] * 5 + [_V, _V]
        fn.restype = _I
        _launch = fn
    return _launch


def topk_select(scores: torch.Tensor, payload: torch.Tensor, k: int):
    """scores/payload int32[B, C] -> (top_s[B, k], top_p[B, k]): the kernel
    on CUDA tensors, the plain version on CPU tensors."""
    global launches
    if scores.is_cpu:
        return topk_select_plain(scores, payload, k)
    dev = scores.get_device()
    if dev < 0 or payload.get_device() != dev \
            or scores.dtype is not torch.int32 \
            or payload.dtype is not torch.int32 or scores.dim() != 2 \
            or payload.shape != scores.shape or not scores.is_contiguous() \
            or not payload.is_contiguous():
        raise ValueError(
            "topk_select: scores and payload must be contiguous int32 "
            f"[B, C] tensors of one shape on one CUDA device; got "
            f"{scores.dtype} {tuple(scores.shape)} on {scores.device} and "
            f"{payload.dtype} {tuple(payload.shape)} on {payload.device}")
    B, C = scores.shape
    if not 1 <= k <= C:
        raise ValueError(f"topk_select: needs 1 <= k <= C; got k={k}, C={C}")
    keys, threads = launch_plan(C, B, _build.sm_count(dev))
    out = scores.new_empty((2, B, k))   # int32, on the rows' device
    err = _lib()(scores.data_ptr(), payload.data_ptr(), B, C, k, keys,
                 threads, out.data_ptr(), _build.raw_stream(dev))
    if err:
        _build.check_launch("topk_select", err)
    launches += 1
    return out.unbind(0)
