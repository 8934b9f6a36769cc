"""Engine data structures: the device-resident trie and the static config.

:class:`DeviceTrie` is the tensor encoding of a built TT/ET/HT/plain index
(one NamedTuple of tensors on one device), in the dense layout or the
compressed one.
:class:`EngineConfig` holds every static shape parameter; it is frozen and
hashable, and it names the execution ``substrate`` (see
:mod:`repro_torch.core.engine.substrate`) the entry points dispatch through.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

INT_MAX = 2**31 - 1
NEG_ONE = -1


def resolve_device(device=None) -> torch.device:
    """The device an index lives on: CUDA unless the caller names another.
    The default raises on a host without CUDA — it never carries on on the
    CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: repro_torch runs on the card unless the caller "
            "passes device='cpu'")
    return dev


class DeviceTrie(NamedTuple):
    # dict-trie node arrays
    depth: torch.Tensor        # int32[N]
    max_score: torch.Tensor    # int32[N]
    leaf_score: torch.Tensor   # int32[N]
    leaf_sid: torch.Tensor     # int32[N]
    syn_mask: torch.Tensor     # bool[N]
    tout: torch.Tensor         # int32[N]
    # dict child CSR
    first_child: torch.Tensor  # int32[N+1]
    edge_char: torch.Tensor    # int32[E]
    edge_child: torch.Tensor   # int32[E]
    # synonym child CSR
    s_first_child: torch.Tensor
    s_edge_char: torch.Tensor
    s_edge_child: torch.Tensor
    # emissions
    emit_ptr: torch.Tensor
    emit_node: torch.Tensor
    emit_score: torch.Tensor
    emit_is_leaf: torch.Tensor  # bool[M]
    # rule plane: teleports as a dense -1 padded plane, the link store as
    # a per-anchor CSR over rule-sorted rows
    tele_plane: torch.Tensor   # int32[N, tele_width]
    link_ptr: torch.Tensor     # int32[N+1]
    link_rule: torch.Tensor    # int32[Lk]
    link_target: torch.Tensor  # int32[Lk]
    # rule trie (CSR children + dense term plane)
    r_first_child: torch.Tensor
    r_edge_char: torch.Tensor
    r_edge_child: torch.Tensor
    r_term_plane: torch.Tensor  # int32[Nr, term_width], -1 padded
    r_rule_len: torch.Tensor
    # materialized per-node top-K (dummy (1,1) when disabled)
    topk_score: torch.Tensor
    topk_sid: torch.Tensor
    # -- compressed layout (trie_build.pack_compressed) ------------------
    # None when compression="none"; when packed, the dense per-node arrays
    # above are 0-size dummies and every engine read goes through these
    # sparse, narrow-dtype side tables (repro_torch.core.engine.packed).
    # Node ids stay logical, so results are bit-identical.
    p_labels: torch.Tensor | None = None      # u8[N]
    p_flags: torch.Tensor | None = None       # u8[N]
    c_ids: torch.Tensor | None = None         # i32[C]
    c_tout: torch.Tensor | None = None        # i32[C]
    c_maxscore: torch.Tensor | None = None    # u16/i32[C]
    c_eptr: torch.Tensor | None = None        # i32[C+1]
    c_enode: torch.Tensor | None = None       # i32[Me]
    c_escore: torch.Tensor | None = None      # u16/i32[Me]
    c_eleaf: torch.Tensor | None = None       # u8[Me]
    b_ids: torch.Tensor | None = None         # i32[B]
    b_ptr: torch.Tensor | None = None         # i32[B+1]
    b_char: torch.Tensor | None = None        # u8[Eb]
    b_child: torch.Tensor | None = None       # i32[Eb]
    sb_ids: torch.Tensor | None = None        # i32[Sb]
    sb_ptr: torch.Tensor | None = None        # i32[Sb+1]
    sb_char: torch.Tensor | None = None       # u8[Esb]
    sb_child: torch.Tensor | None = None      # i32[Esb]
    l_ids: torch.Tensor | None = None         # i32[S]
    l_sid: torch.Tensor | None = None         # u16/i32[S]
    t_ids: torch.Tensor | None = None         # i32[Tn]
    t_plane: torch.Tensor | None = None       # i32[Tn, tele_width]
    la_ids: torch.Tensor | None = None        # i32[La]
    la_ptr: torch.Tensor | None = None        # i32[La+1]
    pc_score: torch.Tensor | None = None      # u16/i32[C, K]
    pc_base: torch.Tensor | None = None       # i32[C]
    pc_sid: torch.Tensor | None = None        # u16/i32[C, K]
    # the port's own: a static search tree over c_ids (packed.rank_tree),
    # built on the device with the index, read by the CUDA cached merge
    c_tree: torch.Tensor | None = None        # i32[~C/15]


@dataclass(frozen=True)
class EngineConfig:
    """Static engine shape parameters (hashable)."""

    frontier: int = 32          # F: locus DP width
    gens: int = 48              # W: generator pool width (beam phase)
    expand: int = 8             # P: emissions popped per beam step
    max_steps: int = 256        # beam step cap
    rule_matches: int = 0       # M: max lhs matches per query position
    max_lhs_len: int = 0        # rule-trie walk depth
    # bounded-edit mode: frontier entries become the int32 states
    # ``node * (edit_budget + 1) + edits_used``
    edit_budget: int = 0        # E: max edits spent matching the query
    branch_width: int = 1       # max dict fanout (child-window width)
    max_terms_per_node: int = 1
    teleports: int = 0          # Ts: max teleport targets per node
    # column counts of tele_plane / r_term_plane (always >= 1)
    tele_width: int = 1
    term_width: int = 1
    # widths of the tile-aligned flat-table layout the container carries
    # (checked on load; one CUDA kernel reads any row, so the port does
    # not window by them)
    walk_tile: int = 8
    emit_tile: int = 8
    link_tile: int = 8
    use_cache: bool = False     # phase 2 via materialized top-K
    cache_k: int = 0
    substrate: str = "torch"    # execution substrate ("torch" | "cuda")
    # the JAX package's VMEM budget (IndexSpec.memory_budget), carried so
    # configs round-trip; no effect on the card (one kernel, both tiers)
    memory_budget: int = 0
    # on-device layout: "none" keeps the uniform-i32 tables, "packed" the
    # compressed ones; table_widths records the dtype tier of each
    # tier-variable packed table as a sorted (name, dtype) tuple
    compression: str = "none"
    table_widths: tuple = ()
