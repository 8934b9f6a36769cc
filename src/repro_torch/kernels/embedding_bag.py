"""CUDA kernel: EmbeddingBag over a dense [B, MB] index matrix.

Replaces ``repro/kernels/embedding_bag.py:41`` ``embedding_bag_dense``:
out[b] = Σ_m w[b, m] · table[idx[b, m]] over the entries with idx >= 0
(an index past the table reads its last row, as the TPU kernel's clip
does), divided by max(#valid, 1) in ``"mean"`` mode.  The table is
float32 or bfloat16; the output has its type and the sum is taken in
float32.  One block per bag (``csrc/embedding_bag.cu``), each thread a
column stripe, so every gathered row is read once and coalesced.

Bound on the H100: the bytes gathered — one table row per valid index —
plus the indices, weights and output.

:func:`embedding_bag_dense` launches the kernel for CUDA tensors and
answers CPU tensors with :func:`embedding_bag_dense_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

#: kernel launches (each :func:`embedding_bag_dense` call on CUDA tensors
#: adds one) and plain-version calls
launches = 0
plain_calls = 0

MODES = ("sum", "mean")
_V, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def embedding_bag_dense_plain(table: torch.Tensor, idx: torch.Tensor,
                              weights: torch.Tensor, mode: str = "sum"):
    """The plain version: gather, weight and reduce in float32, then the
    table's type."""
    global plain_calls
    plain_calls += 1
    valid = idx >= 0
    rows = table[idx.clamp(0, int(table.shape[0]) - 1).long()].float()
    rows = torch.where(valid[..., None], rows * weights.float()[..., None],
                       0.0)
    out = rows.sum(dim=1)
    if mode == "mean":
        out = out / valid.sum(dim=1).clamp(min=1)[:, None].float()
    return out.to(table.dtype)


def launch_threads(dim: int) -> int:
    """Threads of one block: a warp multiple, at most 256, no more than
    the row's columns need."""
    return min(256, max(32, (dim + 31) // 32 * 32))


def _lib():
    fn = _build.library("embedding_bag").embedding_bag_launch
    if fn.argtypes is None:
        fn.argtypes = [_V, _LL, _I, _V, _V, _I, _I, _I, _I, _I, _V, _V]
        fn.restype = _I
    return fn


def embedding_bag_dense(table: torch.Tensor, idx: torch.Tensor,
                        weights: torch.Tensor, mode: str = "sum"):
    """table [V, D] float32|bfloat16, idx int32[B, MB] (-1 skipped),
    weights [B, MB] -> [B, D] in the table's type: the kernel on CUDA
    tensors, the plain version on CPU tensors."""
    global launches
    if mode not in MODES:
        raise ValueError(f"embedding_bag: mode must be one of {MODES}, "
                         f"got {mode!r}")
    if table.device.type == "cpu":
        return embedding_bag_dense_plain(table, idx, weights, mode)
    dev = table.device
    name = "embedding_bag"
    weights = weights.to(table.dtype)
    _build.check_tensors(name, dev, (torch.float32, torch.bfloat16),
                         table=table, weights=weights)
    _build.check_tensors(name, dev, (torch.int32,), idx=idx)
    if (table.dim() != 2 or idx.dim() != 2 or weights.shape != idx.shape
            or table.shape[0] < 1):
        raise ValueError(f"{name}: table {tuple(table.shape)}, idx "
                         f"{tuple(idx.shape)} and weights "
                         f"{tuple(weights.shape)} must be [V >= 1, D], "
                         "[B, MB] and [B, MB]")
    B, MB = idx.shape
    V, D = table.shape
    if 8 * MB > _build.MAX_SHARED_BYTES:
        raise ValueError(f"{name}: a bag of {MB} entries needs {8 * MB} B "
                         f"of shared memory; a block has "
                         f"{_build.MAX_SHARED_BYTES}")
    out = torch.empty((B, D), dtype=table.dtype, device=dev)
    p = _build.ptr
    err = _lib()(p(table), V, D, p(idx), p(weights), B, MB,
                 int(mode == "mean"), int(table.dtype == torch.bfloat16),
                 launch_threads(D), p(out), _build.stream(dev))
    _build.check_launch(name, err)
    launches += 1
    return out
