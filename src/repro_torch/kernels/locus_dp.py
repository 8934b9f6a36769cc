"""CUDA kernel: fused synonym-aware locus DP (phase 1, tt/et/ht, e=0).

Replaces ``repro/kernels/locus_dp.py:732`` ``locus_dp_walk`` and ``:773``
``locus_dp_walk_streamed``: every table sits in device memory, so one
kernel (``csrc/locus_dp.cu``) covers both tiers.  One thread block per
query keeps the whole (L+1, F) frontier buffer in shared memory; every
merge is a block-wide bitonic sort of the candidate row and a prefix-sum
compaction, bit-identical to ``dedup_pad`` (ids ascending, first F kept,
overflow += max(uniques - F, 0)).

Bound on the H100: block-wide synchronisation and dependent table loads,
not bandwidth — a query reads a few bytes per live frontier entry and
position.  The frontier never leaves shared memory between positions.

Shared memory is sized from (L, F, tele_width); a shape that needs more
than a block may have (227 KB) raises — there is no fallback.

:func:`locus_dp_walk` launches the kernel for CUDA tensors and answers CPU
tensors with :func:`locus_dp_plain`, the plain PyTorch version
(:func:`repro_torch.core.engine.locus.locus_dp`).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.engine import locus
from repro_torch.core.engine.structs import DeviceTrie, EngineConfig
from repro_torch.kernels import _build
from repro_torch.not_ported import not_ported

#: kernel launches (each :func:`locus_dp_walk` call on CUDA tensors adds one)
launches = 0

#: the plain version: the engine's reference frontier DP
locus_dp_plain = locus.locus_dp

_V, _I = ctypes.c_void_p, ctypes.c_int


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def launch_shape(cfg: EngineConfig, seq_len: int):
    """(candidate capacity, threads, shared bytes) of one block; raises
    when the shared memory exceeds what a block may have."""
    F = cfg.frontier
    cand = _pow2(max(3 * F, F * (1 + cfg.tele_width) if cfg.teleports else 0))
    threads = min(1024, max(32, cand // 2))
    ints = (seq_len + 1) * F + 3 * cand + seq_len + 2 * max(cfg.rule_matches, 1)
    shared = 4 * ints
    if shared > _build.MAX_SHARED_BYTES:
        raise ValueError(
            f"locus_dp: L={seq_len}, F={F}, tele_width={cfg.tele_width} "
            f"need {shared} bytes of shared memory per block, more than "
            f"the {_build.MAX_SHARED_BYTES} a block may have")
    return cand, threads, shared


def _lib():
    fn = _build.library("locus_dp").locus_dp_launch
    if fn.argtypes is None:
        fn.argtypes = ([_V, _V, _V, _I, _V, _V, _V, _I, _V, _V, _V, _I, _I,
                        _V, _V, _V, _I, _V, _V, _V, _I, _V, _I]
                       + [_I] * 8 + [_V, _V, _I, _V, _V, _V])
        fn.restype = _I
    return fn


def locus_dp_walk(t: DeviceTrie, cfg: EngineConfig, queries: torch.Tensor,
                  qlens: torch.Tensor):
    """Locus antichains + overflow counts of a query batch: the kernel on
    CUDA tensors, the plain version on CPU tensors.

    queries int32[B, L] (-1 padded), qlens int32[B] ->
    (loci[B, F] int32, overflow[B] int32)."""
    global launches
    if queries.device.type == "cpu":
        return locus_dp_plain(t, cfg, queries, qlens)
    if cfg.edit_budget:
        raise not_ported("edits")
    dev = queries.device
    tables = dict(
        first_child=t.first_child, edge_char=t.edge_char,
        edge_child=t.edge_child, s_first_child=t.s_first_child,
        s_edge_char=t.s_edge_char, s_edge_child=t.s_edge_child,
        syn_mask=t.syn_mask, tout=t.tout, tele_plane=t.tele_plane,
        link_ptr=t.link_ptr, link_rule=t.link_rule,
        link_target=t.link_target, r_first_child=t.r_first_child,
        r_edge_char=t.r_edge_char, r_edge_child=t.r_edge_child,
        r_term_plane=t.r_term_plane)
    _build.check_tensors("locus_dp", dev, queries=queries, qlens=qlens,
                         **tables)
    if t.syn_mask.dtype != torch.bool:
        raise TypeError("locus_dp: syn_mask must be bool")
    B, L = queries.shape
    F = cfg.frontier
    cand, threads, shared = launch_shape(cfg, L)
    loci = torch.empty((B, F), dtype=torch.int32, device=dev)
    overflow = torch.empty(B, dtype=torch.int32, device=dev)
    p = _build.ptr
    err = _lib()(
        p(t.first_child), p(t.edge_char), p(t.edge_child),
        int(t.edge_char.shape[0]),
        p(t.s_first_child), p(t.s_edge_char), p(t.s_edge_child),
        int(t.s_edge_char.shape[0]),
        p(t.syn_mask), p(t.tout), p(t.tele_plane),
        int(t.tele_plane.shape[1]), cfg.teleports,
        p(t.link_ptr), p(t.link_rule), p(t.link_target),
        int(t.link_rule.shape[0]),
        p(t.r_first_child), p(t.r_edge_char), p(t.r_edge_child),
        int(t.r_edge_char.shape[0]), p(t.r_term_plane),
        int(t.r_term_plane.shape[1]),
        F, L, cfg.rule_matches, cfg.max_lhs_len, cfg.max_terms_per_node,
        cand, threads, shared,
        p(queries), p(qlens), B, p(loci), p(overflow), _build.stream(dev))
    _build.check_launch("locus_dp", err)
    launches += 1
    return loci, overflow
