"""CUDA kernel: batched longest-prefix trie walk (phase 1, rule-free tries).

Replaces ``repro/kernels/trie_walk.py:81`` ``trie_walk`` and ``:148``
``trie_walk_streamed``: the CSR tables sit in device memory, so one kernel
(``csrc/trie_walk.cu``) covers both the VMEM-resident and the DMA-streamed
tier.  One warp walks one query, the query in registers; a step reads the
node's pointer pair, then its child row (a lane an edge) and finds the
character by a ballot.  Two entries share the kernel:

- :func:`trie_walk` -> (node, depth), the contract of
  ``repro.kernels.ops.trie_walk``;
- :func:`trie_walk_loci` -> (loci[B, F], overflow[B]), the rule-free
  route's phase 1 (``repro/core/engine/substrate.py:331-334``) with its
  epilogue written by the kernel: one launch and one allocation.

Bound on the H100: latency — the chain of dependent loads along the
batch's longest walk (two a character); the bytes a walk reads take far
less than a microsecond at 3.35 TB/s.  End to end, the host's launch: so
the tables are checked once per index (:func:`_tables`), and a call checks
only the queries and their lengths, allocates its outputs as one tensor
and makes one ctypes call.

Both entries launch the kernel for CUDA tensors and answer CPU tensors
with their plain PyTorch versions (:func:`trie_walk_plain`,
:func:`trie_walk_loci_plain`).
"""

from __future__ import annotations

import ctypes
import functools
import weakref

import torch

from repro_torch.core.engine.primitives import csr_child_lookup, iters_for
from repro_torch.core.engine.structs import NEG_ONE
from repro_torch.kernels import _build
from repro_torch.kernels.topk_select import SMS, launch_plan as select_plan

#: kernel launches (each call of either entry on CUDA tensors adds one)
launches = 0
#: of those, the launches of :func:`trie_walk_loci`
loci_launches = 0
#: calls of the plain version (the loci entry's plain version counts here
#: too: it runs :func:`trie_walk_plain`)
plain_calls = 0

_V, _I = ctypes.c_void_p, ctypes.c_int


def trie_walk_plain(first_child, edge_char, edge_child, queries, qlens):
    """Deepest locus node + matched depth of each query (plain PyTorch).

    queries int32[B, L] (-1 padded), qlens int32[B] -> (node[B], depth[B])
    int32.  A step is taken while every earlier step matched, the position
    is inside the query, and the character is a real one."""
    global plain_calls
    plain_calls += 1
    B, L = queries.shape
    node = torch.zeros(B, dtype=torch.int32, device=queries.device)
    matched = torch.zeros(B, dtype=torch.int32, device=queries.device)
    if int(edge_char.shape[0]) == 0:
        return node, matched
    iters = iters_for(int(edge_char.shape[0]))
    for i in range(L):
        c = queries[:, i]
        child = csr_child_lookup(first_child, edge_char, edge_child, node, c,
                                 iters)
        take = (child >= 0) & (matched == i) & (i < qlens)
        node = torch.where(take, child, node)
        matched = torch.where(take, matched + 1, matched)
    return node, matched


def trie_walk_loci_plain(first_child, edge_char, edge_child, queries, qlens,
                         frontier: int):
    """The rule-free phase 1 (plain PyTorch): (loci int32[B, frontier],
    overflow int32[B]).  Column 0 is the walk's node where it matched the
    whole query, else -1; the other columns are -1; overflow is 0."""
    node, depth = trie_walk_plain(first_child, edge_char, edge_child,
                                  queries, qlens)
    B = int(queries.shape[0])
    loci = torch.full((B, frontier), NEG_ONE, dtype=torch.int32,
                      device=queries.device)
    loci[:, 0] = torch.where(depth == qlens, node, NEG_ONE)
    return loci, torch.zeros(B, dtype=torch.int32, device=queries.device)


@functools.lru_cache(maxsize=None)
def launch_plan(B: int, sms: int = SMS):
    """(threads, blocks) of a launch over B queries, a warp a query: the
    warps a block of ``topk_select``'s warp path (the fewest, at most
    eight, that still give every SM at most one block)."""
    _, threads = select_plan(1, B, sms)
    return threads, -(-B // (threads // 32))


class _Trie(ctypes.Structure):
    """The kernel's ``Trie`` (``csrc/trie_walk.cu``), field for field."""

    _fields_ = [("first_child", _V), ("edge_char", _V), ("edge_child", _V),
                ("n_edges", _I), ("pad_", _I)]


#: per index (keyed by the id of its ``first_child``, dropped when that
#: table is freed): (the edge tables it was checked with, the kernel's
#: ``_Trie``, its address, the device index)
_checked: dict[int, tuple] = {}


def _tables(first_child, edge_char, edge_child):
    """The checked ``_Trie`` of an index's CSR tables, built and validated
    on first use.  An entry is reused only while the very same edge
    tensors come with the same ``first_child``, so a freed index's
    pointers never reach another."""
    entry = _checked.get(id(first_child))
    if entry is not None and entry[0][0] is edge_char \
            and entry[0][1] is edge_child:
        return entry
    name = "trie_walk"
    dev = first_child.device
    _build.check_tensors(name, dev, first_child=first_child,
                         edge_char=edge_char, edge_child=edge_child)
    for arg, x in (("first_child", first_child), ("edge_char", edge_char),
                   ("edge_child", edge_child)):
        _build.check_dtype(name, arg, x, torch.int32)
        if x.dim() != 1:
            raise ValueError(f"{name}: {arg} must be one-dimensional, got "
                             f"shape {tuple(x.shape)}")
    n_edges = int(edge_char.shape[0])
    if int(edge_child.shape[0]) != n_edges:
        raise ValueError(f"{name}: {n_edges} edge characters and "
                         f"{int(edge_child.shape[0])} edge children")
    if n_edges > 2**31 - 64:
        raise ValueError(f"{name}: {n_edges} edges do not fit int32 "
                         "indexing")
    if n_edges and int(first_child.shape[0]) < 2:
        raise ValueError(f"{name}: first_child needs a pointer pair for the "
                         "root")
    trie = _Trie(first_child.data_ptr(), edge_char.data_ptr(),
                 edge_child.data_ptr(), n_edges, 0)
    entry = ((edge_char, edge_child), trie, ctypes.addressof(trie),
             dev.index)
    key = id(first_child)
    _checked[key] = entry
    weakref.finalize(first_child, _checked.pop, key, None)
    return entry


_launch_fn = None


def _lib():
    global _launch_fn
    if _launch_fn is None:
        fn = _build.library("trie_walk").trie_walk_launch
        fn.argtypes = [_V, _V, _V] + [_I] * 5 + [_V, _V]
        fn.restype = _I
        _launch_fn = fn
    return _launch_fn


def _launch(first_child, edge_char, edge_child, queries, qlens,
            frontier: int, size):
    """Launch the kernel into a new int32 tensor of ``size`` on the
    queries' device; ``frontier`` 0 writes (node, depth), F > 0 the
    loci and overflow."""
    global launches
    _, _, addr, dev = _tables(first_child, edge_char, edge_child)
    if queries.get_device() != dev or queries.dtype is not torch.int32 \
            or queries.dim() != 2 or not queries.is_contiguous() \
            or qlens.get_device() != dev or qlens.dtype is not torch.int32 \
            or qlens.shape != queries.shape[:1] \
            or not qlens.is_contiguous():
        raise ValueError(
            f"trie_walk: queries and qlens must be contiguous int32 [B, L] "
            f"and [B] tensors on cuda:{dev}; got {queries.dtype} "
            f"{tuple(queries.shape)} on {queries.device} and {qlens.dtype} "
            f"{tuple(qlens.shape)} on {qlens.device}")
    B, L = queries.shape
    threads, blocks = launch_plan(B, _build.sm_count(dev))
    out = queries.new_empty(size)
    err = _lib()(addr, queries.data_ptr(), qlens.data_ptr(), B, L, frontier,
                 threads, blocks, out.data_ptr(), _build.raw_stream(dev))
    if err:
        _build.check_launch("trie_walk", err)
    launches += 1
    return out


def trie_walk(first_child, edge_char, edge_child, queries, qlens):
    """Batched longest-prefix walk: the kernel on CUDA tensors, the plain
    version on CPU tensors.  Same contract as :func:`trie_walk_plain`."""
    if queries.is_cpu:
        return trie_walk_plain(first_child, edge_char, edge_child, queries,
                               qlens)
    out = _launch(first_child, edge_char, edge_child, queries, qlens, 0,
                  (2, int(queries.shape[0])))
    return out.unbind(0)


def trie_walk_loci(first_child, edge_char, edge_child, queries, qlens,
                   frontier: int):
    """The rule-free phase 1 in one launch: (loci int32[B, frontier],
    overflow int32[B]) — the kernel on CUDA tensors, the plain version on
    CPU tensors.  Same contract as :func:`trie_walk_loci_plain`."""
    if frontier < 1:
        raise ValueError(f"trie_walk_loci: frontier must be >= 1, got "
                         f"{frontier}")
    if queries.is_cpu:
        return trie_walk_loci_plain(first_child, edge_char, edge_child,
                                    queries, qlens, frontier)
    global loci_launches
    B = int(queries.shape[0])
    out = _launch(first_child, edge_char, edge_child, queries, qlens,
                  frontier, B * (frontier + 1))
    loci_launches += 1
    loci, overflow = out.split((B * frontier, B))
    return loci.view(B, frontier), overflow
