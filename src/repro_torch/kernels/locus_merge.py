"""CUDA kernel: the cached phase 2 — per-node top-K gather + merge.

Replaces ``repro/kernels/locus_merge.py:53`` ``locus_topk_merge`` and,
for the packed layout, the decode that ``repro/kernels/ops.py:285``
``cached_topk_merge_packed`` runs around it.  ``csrc/locus_merge.cu``
gathers the F*K candidates of a query's loci — loci-major, K-minor, -1
where empty; on a packed index through each locus's chain-representative
rank in ``c_ids`` (by the index's static search tree ``c_tree``),
decoding only the u16 rows it reads — and takes k rounds of argmax, ties
to the first maximum.  ``k >= F*K`` sorts the whole union and pads with
-1, inside the kernel.  Up to F*K = 1,024 candidates a warp takes a query
with the candidates in registers (:func:`launch_plan`); wider unions take
a block each.

Bound on the H100: latency (the rank search's dependent loads, the
gather, the k dependent rounds) and, end to end, the host's launch — a
query reads its F cache rows once.  So a launch is lean: the index's
tables are checked once and kept, with the launch's argument prefix, per
index (:func:`_tables`); a call checks only ``loci``, allocates both
outputs at once and makes one ctypes call.

:func:`locus_topk_merge` launches the kernel for CUDA tensors and answers
CPU tensors with :func:`locus_merge_plain`, the plain PyTorch version
(:func:`repro_torch.core.engine.cached.cached_topk`).
:func:`dense_topk_merge` is the same over a dense cache given as its two
tables, as ``repro``'s ``ops.cached_topk_merge`` takes it.
"""

from __future__ import annotations

import ctypes
import functools
import weakref

import torch

from repro_torch.core.engine import cached
from repro_torch.core.engine import packed as pk
from repro_torch.core.engine.structs import DeviceTrie
from repro_torch.kernels import _build
from repro_torch.kernels.topk_select import SMS, launch_plan as select_plan

#: kernel launches (each :func:`locus_topk_merge` call on CUDA tensors
#: adds one)
launches = 0

#: the plain version: gather + stable sort of the candidate union
locus_merge_plain = cached.cached_topk

_V, _I = ctypes.c_void_p, ctypes.c_int
_NAME = "locus_topk_merge"


class _Cache(ctypes.Structure):
    """The kernel's ``Cache`` (``csrc/locus_merge.cu``), field for field."""

    _fields_ = [("score", _V), ("sid", _V), ("base", _V), ("c_ids", _V),
                ("tree", _V), ("packed", _I), ("K", _I), ("score_u16", _I),
                ("sid_u16", _I), ("n_c", _I), ("pad_", _I)]


@functools.lru_cache(maxsize=None)
def launch_plan(F: int, K: int, B: int, sms: int = SMS):
    """(keys a lane, threads, shared bytes) of a launch: the warp path
    (keys a lane 1-32, one query a warp, F rows and their score bases in
    shared memory a warp) up to F*K = 1,024 candidates, else the block
    path (0 keys a lane, the candidates staged in shared memory); raises
    when those exceed what a block may have."""
    regs, threads = select_plan(F * K, B, sms)
    shared = 8 * F * (threads // 32) if regs else 4 * (2 * F * K + F)
    if shared > _build.MAX_SHARED_BYTES:
        raise ValueError(
            f"locus_topk_merge: F={F}, K={K} need {shared} bytes of shared "
            f"memory per block, more than the {_build.MAX_SHARED_BYTES} a "
            "block may have")
    return regs, threads, shared


#: per cache, an index's or two raw tables (keyed by the id of its score
#: table, dropped when that table is freed): (the other tables it was
#: checked with, the kernel's ``_Cache``, its address, the device index)
_checked: dict[int, tuple] = {}


def _remember(score: torch.Tensor, held: tuple, build):
    """The checked entry of a cache whose score table is ``score``:
    reused only while the very same table tensors are the cache's, so a
    freed index's pointers never reach another; else ``build()`` checks
    the tables and makes the kernel's ``_Cache``."""
    entry = _checked.get(id(score))
    if entry is not None and all(a is b for a, b in zip(entry[0], held)):
        return entry
    cache = build()
    sid = held[0]
    if score.dim() != 2 or sid.shape != score.shape \
            or not 0 < score.numel() < 2**31:
        raise ValueError(f"{_NAME}: cache tables {tuple(score.shape)} and "
                         f"{tuple(sid.shape)} must be one non-empty [rows, "
                         "K] shape of fewer than 2^31 entries")
    entry = (held, cache, ctypes.addressof(cache), score.device.index)
    key = id(score)
    _checked[key] = entry
    weakref.finalize(score, _checked.pop, key, None)
    return entry


def _dense_tables(score: torch.Tensor, sid: torch.Tensor):
    """The checked ``_Cache`` of a dense cache's two tables."""

    def build():
        _build.check_tensors(_NAME, score.device, topk_score=score,
                             topk_sid=sid)
        _build.check_dtype(_NAME, "topk_score", score, torch.int32)
        _build.check_dtype(_NAME, "topk_sid", sid, torch.int32)
        return _Cache(score.data_ptr(), sid.data_ptr(), None, None, None,
                      0, int(score.shape[1]), 0, 0, 0, 0)

    return _remember(score, (sid,), build)


def _tables(t: DeviceTrie):
    """The checked ``_Cache`` of an index's cache tables, either layout,
    built and validated on first use."""
    if t.pc_score is None:
        if pk.is_packed(t) or t.topk_score is None \
                or int(t.topk_score.shape[0]) != int(t.depth.shape[0]):
            raise ValueError(f"{_NAME}: the index carries no top-K cache")
        return _dense_tables(t.topk_score, t.topk_sid)
    score = t.pc_score
    held = (t.pc_sid, t.pc_base, t.c_ids, t.c_tree)

    def build():
        sid, base, c_ids, tree = held
        if not pk.is_packed(t):
            raise ValueError(f"{_NAME}: pc_score on an index without the "
                             "packed layout")
        if tree is None:
            raise ValueError(f"{_NAME}: a packed index needs its c_ids "
                             "search tree (c_tree; see packed.rank_tree)")
        dev = score.device
        _build.check_tensors(_NAME, dev, _build.PACKED_DTYPES,
                             pc_score=score, pc_sid=sid)
        _build.check_tensors(_NAME, dev, pc_base=base, c_ids=c_ids,
                             c_tree=tree)
        for arg, x in (("pc_base", base), ("c_ids", c_ids),
                       ("c_tree", tree)):
            _build.check_dtype(_NAME, arg, x, torch.int32)
        for arg, x in (("c_ids", c_ids), ("c_tree", tree)):
            if x.data_ptr() % 16:
                raise ValueError(f"{_NAME}: {arg} is not 16-byte aligned")
        n_c = int(c_ids.shape[0])
        if int(score.shape[0]) != n_c:
            raise ValueError(f"{_NAME}: {int(score.shape[0])} cache rows "
                             f"for {n_c} stored nodes")
        if int(tree.shape[0]) != pk.rank_tree_size(n_c):
            raise ValueError(f"{_NAME}: c_tree has {int(tree.shape[0])} "
                             f"keys, not the {pk.rank_tree_size(n_c)} of "
                             f"{n_c} ids")
        return _Cache(score.data_ptr(), sid.data_ptr(), base.data_ptr(),
                      c_ids.data_ptr(), tree.data_ptr(), 1,
                      int(score.shape[1]),
                      _build.is_u16(_NAME, "pc_score", score),
                      _build.is_u16(_NAME, "pc_sid", sid), n_c, 0)

    return _remember(score, held, build)


_launch = None


def _lib():
    global _launch
    if _launch is None:
        fn = _build.library("locus_merge").locus_merge_launch
        fn.argtypes = [_V, _V] + [_I] * 6 + [_V, _V]
        fn.restype = _I
        _launch = fn
    return _launch


def locus_topk_merge(t: DeviceTrie, loci: torch.Tensor, k: int):
    """loci int32[B, F] -> (scores[B, k], sids[B, k]) from the index's
    cache, either layout: the kernel on CUDA tensors, the plain version
    on CPU tensors."""
    if loci.is_cpu:
        return locus_merge_plain(t, loci, k)
    return _merge(_tables(t), loci, k)


def dense_topk_merge(topk_score: torch.Tensor, topk_sid: torch.Tensor,
                     loci: torch.Tensor, k: int):
    """:func:`locus_topk_merge` over a dense cache given as its two
    tables, topk_score/topk_sid int32[N, K] (``repro``'s
    ``ops.cached_topk_merge``): the same kernel, or on CPU tensors
    :func:`repro_torch.core.engine.cached.dense_cached_topk`."""
    if loci.is_cpu:
        return cached.dense_cached_topk(topk_score, topk_sid, loci, k)
    return _merge(_dense_tables(topk_score, topk_sid), loci, k)


def _merge(entry, loci: torch.Tensor, k: int):
    """One launch over a checked cache entry."""
    global launches
    _, cache, addr, dev = entry
    if loci.get_device() != dev or loci.dtype is not torch.int32 \
            or loci.dim() != 2 or not loci.is_contiguous():
        raise ValueError(
            f"{_NAME}: loci must be a contiguous int32 [B, F] "
            f"tensor on cuda:{dev}; got {loci.dtype} "
            f"{tuple(loci.shape)} on {loci.device}")
    if k < 1:
        raise ValueError(f"{_NAME}: k must be >= 1, got {k}")
    B, F = loci.shape
    regs, threads, shared = launch_plan(F, cache.K, B, _build.sm_count(dev))
    out = loci.new_empty((2, B, k))   # int32, on loci's device
    err = _lib()(addr, loci.data_ptr(), B, F, k, regs, threads, shared,
                 out.data_ptr(), _build.raw_stream(dev))
    if err:
        _build.check_launch("locus_merge", err)
    launches += 1
    return out.unbind(0)
