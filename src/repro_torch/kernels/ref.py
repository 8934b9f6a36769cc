"""Plain PyTorch versions of the port's kernels, under the names of the
JAX package's references (``repro.kernels.ref``): each mirrors its
kernel's contract exactly, and the CPU tests hold it against its JAX
counterpart."""

from __future__ import annotations

from repro_torch.kernels.beam_topk import beam_topk_plain as beam_topk_ref
from repro_torch.kernels.locus_dp import locus_dp_plain as locus_walk_ref
from repro_torch.kernels.trie_walk import trie_walk_plain as trie_walk_ref

__all__ = ["beam_topk_ref", "locus_walk_ref", "trie_walk_ref"]
