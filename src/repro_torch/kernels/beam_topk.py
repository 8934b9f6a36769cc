"""CUDA kernel: fused beam phase 2 (generator-pool priority search).

Replaces ``repro/kernels/beam_topk.py:413`` ``beam_topk_batch``, ``:463``
``beam_topk_batch_streamed`` and ``:440`` ``beam_topk_batch_packed``: the
emission tables sit in device memory, so one kernel
(``csrc/beam_topk.cu``) covers both tiers, and its search is templated on
an emission accessor for the dense and the packed layout (two C entry
points, ``beam_topk_launch`` and ``beam_topk_packed_launch``).  One
thread block per query keeps the pool (W), the result heap (k) and
``dropped_max`` in shared memory, and loops while the reference's
condition holds.  The first step sorts as ``lax.top_k`` does, on
``(INT_MAX - bound) << 32 | column``; it leaves the pool in key order, so
every later step pops columns 0..P-1, re-bounds only those, and merges the
2P changed entries into the sorted run (and the P leaves into the heap)
by rank, with two block barriers a step.

Bound on the H100: the chain of block barriers and dependent emission
loads — a query reads only the emissions it pops and the pointer pairs it
re-arms.  It takes every width the main path sends, the widened retry
rounds included (up to W=3072, max_steps=32768 at the default spec).

:func:`beam_topk_batch` launches the kernel for CUDA tensors and answers
CPU tensors with :func:`beam_topk_plain`, the plain PyTorch version
(:func:`repro_torch.core.engine.beam.beam_topk`).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.engine import beam
from repro_torch.core.engine import packed as pk
from repro_torch.core.engine.structs import DeviceTrie, EngineConfig, NEG_ONE
from repro_torch.kernels import _build

#: kernel launches on the dense layout (each :func:`beam_topk_batch` call
#: on CUDA tensors of a dense index that reaches the kernel adds one) and
#: on the packed layout
launches = 0
packed_launches = 0
#: the same launches by width: (layout, edit budget, pool width) -> count
width_launches: dict[tuple[str, int, int], int] = {}

#: the plain version: the engine's reference priority search
beam_topk_plain = beam.beam_topk

_V, _I = ctypes.c_void_p, ctypes.c_int


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def launch_shape(cfg: EngineConfig, k: int):
    """(sort-key capacity, threads, shared bytes) of one block; raises
    when the shared memory exceeds what a block may have.  The keys hold
    the first step's sorts; the block has a thread per two keys (one warp
    at the default widths), and a later step's merges stride over its
    W + P pool entries by it."""
    W, P = cfg.gens, cfg.expand
    keys = _pow2(max(W + P, k + P))
    threads = min(1024, max(32, keys // 2))
    # pool and next pool, heap and next heap, the first step's popped
    # columns and flags, a later step's 2P changed entries and P leaves
    ints = 3 * W + 3 * (W + P) + 2 * k + 2 * (k + P) + 2 * P + 8 * P
    shared = 8 * (keys + 3 * P) + 4 * ints
    if shared > _build.MAX_SHARED_BYTES:
        raise ValueError(
            f"beam_topk: W={W}, P={P}, k={k} need {shared} bytes of shared "
            f"memory per block, more than the {_build.MAX_SHARED_BYTES} a "
            "block may have")
    return keys, threads, shared


def _lib():
    fn = _build.library("beam_topk").beam_topk_launch
    if fn.argtypes is None:
        fn.argtypes = [_V] * 6 + [_I] * 9 + [_V] * 4
        fn.restype = _I
    return fn


def _lib_packed():
    fn = _build.library("beam_topk").beam_topk_packed_launch
    if fn.argtypes is None:
        fn.argtypes = ([_V, _V, _I, _V, _V, _V, _I, _V, _V, _I, _V, _I, _V,
                        _I, _V] + [_I] * 9 + [_V] * 4)
        fn.restype = _I
    return fn


def _packed_emit(t: DeviceTrie, dev: torch.device):
    """The packed entry point's emission arguments, checked: u8 flags and
    leaf bits, int32 ids and pointers, u16 or int32 for the three
    tier-variable tables."""
    name = "beam_topk"
    u8 = dict(p_flags=t.p_flags, c_eleaf=t.c_eleaf)
    i32 = dict(c_ids=t.c_ids, c_eptr=t.c_eptr, c_enode=t.c_enode,
               l_ids=t.l_ids)
    tiers = dict(c_escore=t.c_escore, c_maxscore=t.c_maxscore,
                 l_sid=t.l_sid)
    _build.check_tensors(name, dev, _build.PACKED_DTYPES, **u8, **i32,
                         **tiers)
    for arg, x in u8.items():
        _build.check_dtype(name, arg, x, torch.uint8)
    for arg, x in i32.items():
        _build.check_dtype(name, arg, x, torch.int32)
    u16 = {arg: _build.is_u16(name, arg, x) for arg, x in tiers.items()}
    p = _build.ptr
    return (p(t.p_flags), p(t.c_ids), int(t.c_ids.shape[0]), p(t.c_eptr),
            p(t.c_enode), p(t.c_escore), u16["c_escore"], p(t.c_eleaf),
            p(t.c_maxscore), u16["c_maxscore"], p(t.l_ids),
            int(t.l_ids.shape[0]), p(t.l_sid), u16["l_sid"])


def beam_topk_batch(t: DeviceTrie, cfg: EngineConfig, loci: torch.Tensor,
                    k: int):
    """Beam phase 2 over a locus batch: the kernel on CUDA tensors, the
    plain version on CPU tensors.

    loci int32[B, F] -> (scores[B, k], sids[B, k] int32, exact[B] bool)."""
    global launches, packed_launches
    if loci.device.type == "cpu":
        return beam_topk_plain(t, cfg, loci, k)
    dev = loci.device
    B, F = loci.shape
    beam.check_widths(cfg, F, k)
    if beam.is_empty(t):
        # empty dictionary: mirror the reference's short-circuit
        return (torch.full((B, k), NEG_ONE, dtype=torch.int32, device=dev),
                torch.full((B, k), NEG_ONE, dtype=torch.int32, device=dev),
                torch.ones(B, dtype=torch.bool, device=dev))
    _build.check_tensors("beam_topk", dev, loci=loci)
    packed = pk.is_packed(t)
    if packed:
        head = _packed_emit(t, dev)
    else:
        _build.check_tensors("beam_topk", dev, emit_ptr=t.emit_ptr,
                             emit_node=t.emit_node, emit_score=t.emit_score,
                             emit_is_leaf=t.emit_is_leaf,
                             leaf_sid=t.leaf_sid)
        if t.emit_is_leaf.dtype != torch.bool:
            raise TypeError("beam_topk: emit_is_leaf must be bool")
        p = _build.ptr
        head = (p(t.emit_ptr), p(t.emit_node), p(t.emit_score),
                p(t.emit_is_leaf), p(t.leaf_sid))
    keys, threads, shared = launch_shape(cfg, k)
    scores = torch.empty((B, k), dtype=torch.int32, device=dev)
    sids = torch.empty((B, k), dtype=torch.int32, device=dev)
    exact = torch.empty(B, dtype=torch.bool, device=dev)
    p = _build.ptr
    fn = _lib_packed() if packed else _lib()
    err = fn(*head, p(loci), B, F, cfg.gens, cfg.expand, k, cfg.max_steps,
             keys, threads, shared, p(scores), p(sids), p(exact),
             _build.stream(dev))
    _build.check_launch("beam_topk", err)
    if packed:
        packed_launches += 1
    else:
        launches += 1
    key = ("packed" if packed else "dense", cfg.edit_budget, cfg.gens)
    width_launches[key] = width_launches.get(key, 0) + 1
    return scores, sids, exact
