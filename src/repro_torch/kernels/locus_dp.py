"""CUDA kernel: fused synonym-aware locus DP (phase 1, edit budget 0-2).

Replaces ``repro/kernels/locus_dp.py:732`` ``locus_dp_walk``, ``:773``
``locus_dp_walk_streamed``, ``:832`` ``locus_dp_walk_packed`` and ``:871``
``locus_dp_walk_packed_streamed``: every table sits in device memory, so
one kernel (``csrc/locus_dp.cu``) covers both tiers, and its sweep is
templated on a table accessor for the dense and the packed layout (two C
entry points, ``locus_dp_launch`` and ``locus_dp_packed_launch``).  It
serves dense tt/et/ht indexes and every packed index, the plain kind
included (the packed layout has no dense CSR for the prefix walk).
One thread block per query keeps the whole (L+1, F) frontier buffer in
shared memory and sweeps it up to the query's last character; every
merge compacts its live candidates by warp ballot, sorts only those,
merges the sorted target row with them by merge path and deduplicates by
ballot (in one warp, with no block barrier, up to 256 sorted slots),
bit-identical to ``dedup_pad`` (ids ascending, first F kept, overflow +=
max(uniques - F, 0)).  At an edit budget E > 0 the frontier holds the
states ``node*(E+1)+d`` and the sweep adds the substitute, insert and
delete transitions of ``core/engine/locus.py``, their children laid out
by a prefix over the live states' child windows; every merge stays one
merge, so the overflow counts are the reference's.

Bound on the H100: the chain of block-wide barriers and dependent table
loads, not bandwidth — a query reads a few bytes per live frontier entry
and position.  The frontier never leaves shared memory between positions.

Shared memory is sized from (L, F, tele_width, E, branch_width).  When
the candidate rows of the largest merge do not fit beside the frontier in
the 227 KB a block may have (the widened retry at E > 0 reaches
F·(4+BW) ≈ 10k candidates), each block gets a slice of a device-memory
workspace for them, allocated here with ``torch.empty``, and past that for
the frontier rows too; only a block slice past int32 offsets raises.

:func:`locus_dp_walk` launches the kernel for CUDA tensors and answers CPU
tensors with :func:`locus_dp_plain`, the plain PyTorch version
(:func:`repro_torch.core.engine.locus.locus_dp`).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.core.engine import locus
from repro_torch.core.engine import packed as pk
from repro_torch.core.engine.structs import DeviceTrie, EngineConfig
from repro_torch.kernels import _build

#: kernel launches on the dense layout (each :func:`locus_dp_walk` call on
#: CUDA tensors of a dense index adds one) and on the packed layout
launches = 0
packed_launches = 0
#: the same launches by width: (layout, edit budget, frontier) -> count
width_launches: dict[tuple[str, int, int], int] = {}

#: the plain version: the engine's reference frontier DP
locus_dp_plain = locus.locus_dp

_V, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


class LaunchShape(NamedTuple):
    cand: int          # candidate capacity of one merge (a power of two)
    threads: int       # 4F, at least a warp, at most MAX_THREADS
    shared: int        # dynamic shared bytes of one block
    buf_in_ws: int     # the (L+1, F) frontier rows live in the workspace
    cand_in_ws: int    # the candidate, merged and window rows do
    ws_stride: int     # workspace int32s of one block (0: no workspace)


def merge_widths(cfg: EngineConfig) -> dict[str, int]:
    """Candidates of each merge of one sweep step: the literal step (the
    next row, dict and synonym children, and at E > 0 the insert and
    F·BW substitute states), a rule step, a delete round and a teleport
    expansion."""
    F, BW = cfg.frontier, cfg.branch_width
    edits = cfg.edit_budget > 0
    return {"literal": F * (3 + (1 + BW if edits else 0)),
            "rule": 2 * F,
            "delete": F * (1 + BW) if edits else 0,
            "teleport": F * (1 + cfg.tele_width) if cfg.teleports else 0}


#: the kernel's largest block (``kMaxThreads``, its launch bound: 512
#: threads of up to 128 registers fit an SM's 65,536)
MAX_THREADS = 512
#: the kernel's small scratch (``kScratch``): two candidate counters, the
#: last merge's uniques, the windows' total, the rule matches' count and
#: 32 per-warp counts
_SCRATCH = 37


def fixed_ints(cfg: EngineConfig, seq_len: int) -> int:
    """Shared int32s of one block beside its rows: the query, the rule
    matches of one position, the live count of every row and the
    scratch."""
    return (seq_len + 2 * max(cfg.rule_matches, 1) + seq_len + 1
            + _SCRATCH)


def launch_shape(cfg: EngineConfig, seq_len: int) -> LaunchShape:
    """Where one block keeps its rows: all in shared memory when they fit
    the 227 KB a block may have, else the candidate rows (then the
    frontier too) in a device-memory workspace slice."""
    F = cfg.frontier
    cand = _pow2(max(merge_widths(cfg).values()))
    threads = min(MAX_THREADS, max(32, 4 * _pow2(F)))   # whole warps
    frontier = (seq_len + 1) * F
    small = fixed_ints(cfg, seq_len)
    for buf_in_ws, cand_in_ws in ((0, 0), (0, 1), (1, 1)):
        shared = 4 * (small + (0 if buf_in_ws else frontier)
                      + (0 if cand_in_ws else 3 * cand))
        if shared <= _build.MAX_SHARED_BYTES:
            break
    stride = 3 * cand * cand_in_ws + frontier * buf_in_ws
    if shared > _build.MAX_SHARED_BYTES or stride >= 2**31:
        raise ValueError(
            f"locus_dp: L={seq_len}, F={F}, E={cfg.edit_budget}, "
            f"branch_width={cfg.branch_width}, "
            f"tele_width={cfg.tele_width} need {4 * frontier} B of "
            f"frontier and {12 * cand} B of candidate rows per block: "
            f"{shared} B of shared memory (at most "
            f"{_build.MAX_SHARED_BYTES}) and a workspace slice of "
            f"{stride} int32s (below 2**31)")
    return LaunchShape(cand, threads, shared, buf_in_ws, cand_in_ws, stride)


#: the rule-trie, shape and output arguments both entry points end with
_TAIL = ([_V, _V, _V, _I, _V, _I] + [_I] * 9 + [_LL, _I, _I]
         + [_V, _V, _I, _V, _V, _V, _V])


def _lib():
    fn = _build.library("locus_dp").locus_dp_launch
    if fn.argtypes is None:
        fn.argtypes = ([_V, _V, _V, _I, _V, _V, _V, _I, _V, _V, _V, _I, _I,
                        _V, _V, _V, _I] + _TAIL)
        fn.restype = _I
    return fn


def _lib_packed():
    fn = _build.library("locus_dp").locus_dp_packed_launch
    if fn.argtypes is None:
        fn.argtypes = ([_V, _V, _I, _V, _I, _V, _V, _I, _V, _V, _V, _V, _I,
                        _V, _V, _V, _I, _V, _I, _V, _I, _I, _V, _I, _V, _V,
                        _V, _I] + _TAIL)
        fn.restype = _I
    return fn


def _packed_tables(t: DeviceTrie, dev: torch.device):
    """The packed entry point's table arguments, checked: u8 planes and
    characters, int32 everything else."""
    name = "locus_dp"
    u8 = dict(p_labels=t.p_labels, p_flags=t.p_flags, b_char=t.b_char,
              sb_char=t.sb_char)
    i32 = dict(c_ids=t.c_ids, c_tout=t.c_tout, b_ids=t.b_ids, b_ptr=t.b_ptr,
               b_child=t.b_child, sb_ids=t.sb_ids, sb_ptr=t.sb_ptr,
               sb_child=t.sb_child, t_ids=t.t_ids, t_plane=t.t_plane,
               la_ids=t.la_ids, la_ptr=t.la_ptr, link_rule=t.link_rule,
               link_target=t.link_target)
    _build.check_tensors(name, dev, _build.PACKED_DTYPES, **u8, **i32)
    for arg, x in u8.items():
        _build.check_dtype(name, arg, x, torch.uint8)
    for arg, x in i32.items():
        _build.check_dtype(name, arg, x, torch.int32)
    p = _build.ptr
    return (
        p(t.p_labels), p(t.p_flags), int(t.p_labels.shape[0]),
        p(t.c_ids), int(t.c_ids.shape[0]), p(t.c_tout),
        p(t.b_ids), int(t.b_ids.shape[0]), p(t.b_ptr), p(t.b_char),
        p(t.b_child),
        p(t.sb_ids), int(t.sb_ids.shape[0]), p(t.sb_ptr), p(t.sb_char),
        p(t.sb_child), int(t.sb_child.shape[0]),
        p(t.t_ids), int(t.t_ids.shape[0]), p(t.t_plane),
        int(t.t_plane.shape[1]))


def _dense_tables(t: DeviceTrie, dev: torch.device):
    tables = dict(
        first_child=t.first_child, edge_char=t.edge_char,
        edge_child=t.edge_child, s_first_child=t.s_first_child,
        s_edge_char=t.s_edge_char, s_edge_child=t.s_edge_child,
        syn_mask=t.syn_mask, tout=t.tout, tele_plane=t.tele_plane,
        link_ptr=t.link_ptr, link_rule=t.link_rule,
        link_target=t.link_target)
    _build.check_tensors("locus_dp", dev, **tables)
    if t.syn_mask.dtype != torch.bool:
        raise TypeError("locus_dp: syn_mask must be bool")
    p = _build.ptr
    return (
        p(t.first_child), p(t.edge_char), p(t.edge_child),
        int(t.edge_char.shape[0]),
        p(t.s_first_child), p(t.s_edge_char), p(t.s_edge_child),
        int(t.s_edge_char.shape[0]),
        p(t.syn_mask), p(t.tout), p(t.tele_plane),
        int(t.tele_plane.shape[1]))


def locus_dp_walk(t: DeviceTrie, cfg: EngineConfig, queries: torch.Tensor,
                  qlens: torch.Tensor):
    """Locus antichains + overflow counts of a query batch: the kernel on
    CUDA tensors, the plain version on CPU tensors.

    queries int32[B, L] (-1 padded), qlens int32[B] ->
    (loci[B, F] int32, overflow[B] int32)."""
    global launches, packed_launches
    if queries.device.type == "cpu":
        return locus_dp_plain(t, cfg, queries, qlens)
    locus.check_state_range(t, cfg)
    dev = queries.device
    rule = dict(r_first_child=t.r_first_child, r_edge_char=t.r_edge_char,
                r_edge_child=t.r_edge_child, r_term_plane=t.r_term_plane)
    _build.check_tensors("locus_dp", dev, queries=queries, qlens=qlens,
                         **rule)
    packed = pk.is_packed(t)
    if packed:
        head = _packed_tables(t, dev) + (
            cfg.teleports, _build.ptr(t.la_ids), int(t.la_ids.shape[0]),
            _build.ptr(t.la_ptr))
    else:
        head = _dense_tables(t, dev) + (cfg.teleports, _build.ptr(t.link_ptr))
    B, L = queries.shape
    F = cfg.frontier
    ls = launch_shape(cfg, L)
    loci = torch.empty((B, F), dtype=torch.int32, device=dev)
    overflow = torch.empty(B, dtype=torch.int32, device=dev)
    p = _build.ptr
    ws = (torch.empty(B * ls.ws_stride, dtype=torch.int32, device=dev)
          if ls.ws_stride else None)
    fn = _lib_packed() if packed else _lib()
    err = fn(
        *head, p(t.link_rule), p(t.link_target), int(t.link_rule.shape[0]),
        p(t.r_first_child), p(t.r_edge_char), p(t.r_edge_child),
        int(t.r_edge_char.shape[0]), p(t.r_term_plane),
        int(t.r_term_plane.shape[1]),
        F, L, cfg.rule_matches, cfg.max_lhs_len, cfg.max_terms_per_node,
        ls.cand, cfg.edit_budget, ls.buf_in_ws, ls.cand_in_ws,
        ls.ws_stride, ls.threads, ls.shared,
        p(queries), p(qlens), B, None if ws is None else p(ws), p(loci),
        p(overflow), _build.stream(dev))
    _build.check_launch("locus_dp", err)
    if packed:
        packed_launches += 1
    else:
        launches += 1
    key = ("packed" if packed else "dense", cfg.edit_budget, F)
    width_launches[key] = width_launches.get(key, 0) + 1
    return loci, overflow
