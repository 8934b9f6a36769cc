"""CUDA kernel: fused candidate scoring + top-k.

Replaces ``repro/kernels/candidate_topk.py:51`` ``candidate_topk``: one
query [D] against candidates [C, D], float32 or bfloat16 (each widened to
float32, as the TPU kernel does; scores and the sum in float32), the k
best dot products, score-descending, ties to the lower id (``lax.top_k``'s
order, which is ``repro.kernels.ref.candidate_topk_ref``'s contract);
slots past C hold ``(-3.0e38, -1)``.  ``csrc/candidate_topk.cu`` streams
the candidates once: about two blocks per SM each score a contiguous slice
(16-byte loads, the query in registers) and keep only the rows that beat
their running k-th best key, then one block merges the blocks' lists
(blocks run in no order, so nothing carries across them as the TPU grid's
running top-k does).

Bound on the H100: the bytes of reading the candidates once,
C·D·sizeof(element).

:func:`candidate_topk` launches the kernels for CUDA tensors and answers
CPU tensors with :func:`candidate_topk_plain`.  Neither has a gradient
(a top-k of retrieval is in no loss): with grad mode on, an input that
requires one raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

#: kernel launches (each :func:`candidate_topk` call on CUDA tensors adds
#: one, for its scoring and merge kernels) and plain-version calls
launches = 0
plain_calls = 0

NEG_FILL = -3.0e38
FLOAT_DTYPES = (torch.float32, torch.bfloat16)
#: the scoring kernel's warps, row slots a lane loads at once, and blocks
#: per SM; the merge kernel's threads (csrc/candidate_topk.cu)
WARPS, UNROLL, BLOCKS_PER_SM, MERGE_THREADS = 8, 8, 2, 1024
#: the smallest threshold buffers (keys) of the scoring and merge blocks
MIN_CAP, MIN_MERGE_CAP = 1024, 2048
H100_SMS = 132

_V, _I = ctypes.c_void_p, ctypes.c_int
_launch = None
_sms: dict[int, int] = {}


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


class Plan(NamedTuple):
    """How :func:`candidate_topk` launches: the scoring grid and each
    block's slice of rows, the lanes that read one row, the rows a block
    scores between two looks at its buffer, and the threshold buffers
    (keys) of a scoring block and of the merge block."""
    n_blocks: int
    rows_per_block: int
    lanes_per_row: int
    rows_per_round: int
    cap: int
    merge_cap: int


def max_k(dim: int, elem_bytes: int = 4, vec: bool = True) -> int:
    """The largest k :func:`launch_plan` takes at this row shape: a buffer
    must hold k keys and one round of new ones, in the largest power of two
    of 8-byte keys a block's shared memory holds."""
    cap = 1
    while 16 * cap <= _build.MAX_SHARED_BYTES:
        cap *= 2
    lanes = _build.lanes_per_row(dim, elem_bytes, vec)
    return cap - max(WARPS * UNROLL * (32 // lanes), MERGE_THREADS)


def launch_plan(n_cands: int, dim: int, k: int, block_c: int = 1024,
                elem_bytes: int = 4, vec: bool = True,
                n_sms: int = H100_SMS) -> Plan:
    """The launch of :func:`candidate_topk` for C=``n_cands`` rows of D=``dim``
    values of ``elem_bytes`` each, read with 16-byte loads when ``vec``:
    ``BLOCKS_PER_SM`` blocks per SM, none over fewer than ``block_c`` rows
    (at least one block).  Raises when a threshold buffer would pass a
    block's shared memory (k above :func:`max_k`)."""
    lanes = _build.lanes_per_row(dim, elem_bytes, vec)
    rows = WARPS * UNROLL * (32 // lanes)
    cap = max(MIN_CAP, _pow2(k + rows))
    merge_cap = max(MIN_MERGE_CAP, _pow2(k + MERGE_THREADS))
    need = 8 * max(cap, merge_cap)
    if need > _build.MAX_SHARED_BYTES:
        raise ValueError(
            f"candidate_topk: k={k} at D={dim} needs a buffer of "
            f"{max(cap, merge_cap)} keys ({need} B of shared memory); a block "
            f"has {_build.MAX_SHARED_BYTES} B (k <= "
            f"{max_k(dim, elem_bytes, vec)} here)")
    n_blocks = max(1, min(BLOCKS_PER_SM * n_sms,
                          -(-n_cands // max(1, block_c))))
    return Plan(n_blocks, -(-n_cands // n_blocks), lanes, rows, cap,
                merge_cap)


def _fn():
    global _launch
    if _launch is None:
        fn = _build.library("candidate_topk").candidate_topk_launch
        fn.argtypes = [_V, _I, _V, _I, _I] + [_I] * 8 + [_V] * 4
        fn.restype = _I
        _launch = fn
    return _launch


def _sm_count(dev: torch.device) -> int:
    i = dev.index if dev.index is not None else torch.cuda.current_device()
    if i not in _sms:
        _sms[i] = torch.cuda.get_device_properties(i).multi_processor_count
    return _sms[i]


def candidate_topk(query: torch.Tensor, candidates: torch.Tensor, k: int,
                   block_c: int = 1024):
    """query [D], candidates [C, D], float32 or bfloat16 -> (scores f32[k],
    ids int32[k]): the kernels on CUDA tensors, the plain version on CPU
    tensors."""
    global launches
    _build.refuse_grad("candidate_topk", "no loss goes through a top-k",
                       query=query, candidates=candidates)
    if query.device.type == "cpu":
        return candidate_topk_plain(query, candidates, k, block_c)
    dev = query.device
    name = "candidate_topk"
    _build.check_tensors(name, dev, FLOAT_DTYPES, query=query,
                         candidates=candidates)
    if candidates.dim() != 2 or query.shape != candidates.shape[1:]:
        raise ValueError(f"{name}: query {tuple(query.shape)} and "
                         f"candidates {tuple(candidates.shape)} must be [D] "
                         "and [C, D]")
    C, D = candidates.shape
    if k < 1 or C < 1 or C > 2**31 - 2**12:
        raise ValueError(f"{name}: needs k >= 1 and 1 <= C <= 2**31 - 2**12;"
                         f" got k={k}, C={C}")
    esize = candidates.element_size()
    vec = (D * esize) % 16 == 0 and candidates.data_ptr() % 16 == 0
    plan = launch_plan(C, D, k, block_c, esize, vec, _sm_count(dev))
    keys = torch.empty(plan.n_blocks * k, dtype=torch.int64, device=dev)
    out_s = torch.empty(k, dtype=torch.float32, device=dev)
    out_i = torch.empty(k, dtype=torch.int32, device=dev)
    err = _fn()(query.data_ptr(), int(query.dtype == torch.bfloat16),
                candidates.data_ptr(), int(candidates.dtype == torch.bfloat16),
                int(vec), C, D, plan.rows_per_block, plan.lanes_per_row, k,
                plan.cap, plan.n_blocks, plan.merge_cap, keys.data_ptr(),
                out_s.data_ptr(), out_i.data_ptr(), _build.stream(dev))
    _build.check_launch(name, err)
    launches += 1
    return out_s, out_i
