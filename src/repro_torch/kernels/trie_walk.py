"""CUDA kernel: batched longest-prefix trie walk (phase 1, rule-free tries).

Replaces ``repro/kernels/trie_walk.py:81`` ``trie_walk`` and ``:148``
``trie_walk_streamed``: the CSR tables sit in device memory, so one kernel
(``csrc/trie_walk.cu``) covers both the VMEM-resident and the DMA-streamed
tier.  One thread walks one query; each step is one lower-bound search of
the current child row.

Bound on the H100: latency of dependent loads — the bytes a walk must read
(a pointer pair, a few characters and a child per consumed character) take
far less than a microsecond at 3.35 TB/s.  Independent queries run as
independent threads, so the card overlaps many walks' loads.

:func:`trie_walk` launches the kernel for CUDA tensors and answers CPU
tensors with :func:`trie_walk_plain`, the plain PyTorch version.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.engine.primitives import csr_child_lookup, iters_for
from repro_torch.kernels import _build

#: kernel launches (each :func:`trie_walk` call on CUDA tensors adds one)
launches = 0
#: calls of the plain version
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


def _lib():
    lib = _build.library("trie_walk")
    fn = lib.trie_walk_launch
    if fn.argtypes is None:
        fn.argtypes = [_V, _V, _V, _I, _V, _V, _I, _I, _V, _V, _V]
        fn.restype = _I
    return fn


def trie_walk(first_child, edge_char, edge_child, queries, qlens):
    """Batched longest-prefix walk: the kernel on CUDA tensors, the plain
    version on CPU tensors.  Same contract as :func:`trie_walk_plain`."""
    global launches
    if queries.device.type == "cpu":
        return trie_walk_plain(first_child, edge_char, edge_child, queries,
                               qlens)
    dev = queries.device
    _build.check_tensors("trie_walk", dev, first_child=first_child,
                         edge_char=edge_char, edge_child=edge_child,
                         queries=queries, qlens=qlens)
    B, L = queries.shape
    node = torch.empty(B, dtype=torch.int32, device=dev)
    depth = torch.empty(B, dtype=torch.int32, device=dev)
    p = _build.ptr
    err = _lib()(p(first_child), p(edge_char), p(edge_child),
                 int(edge_char.shape[0]), p(queries), p(qlens), B, L,
                 p(node), p(depth), _build.stream(dev))
    _build.check_launch("trie_walk", err)
    launches += 1
    return node, depth
