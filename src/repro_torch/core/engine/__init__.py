"""The completion engine on tensors: structures, the two phases (and the
incremental phase 1 of a typing session), the substrates that run them,
and the delta overlay that merges online mutations into their top-k.
The substrate registry (:func:`register_substrate`) holds ``"torch"``
(:class:`Substrate`, the plain reference) and ``"cuda"``
(:class:`CudaSubstrate`, the hand-written kernels; ``repro``'s
``PallasSubstrate``)."""

from repro_torch.core.engine.structs import (DeviceTrie, EngineConfig,
                                             INT_MAX, NEG_ONE)
from repro_torch.core.engine.primitives import (csr_child_lookup, dedup_pad,
                                                iters_for, lower_bound)
from repro_torch.core.engine.locus import (finalize_loci, link_lookup,
                                           locus_dp, match_table,
                                           teleport_expand)
from repro_torch.core.engine.beam import beam_topk
from repro_torch.core.engine.cached import cached_topk, gather_cached
from repro_torch.core.engine.substrate import (CudaSubstrate, Substrate,
                                               available_substrates,
                                               complete_batch, complete_one,
                                               get_substrate,
                                               register_substrate,
                                               resolve_substrate, topk_phase2,
                                               topk_phase2_batch)
from repro_torch.core.engine.incremental import (LocusState, advance_loci,
                                                 advance_loci_batch,
                                                 advance_locus_state,
                                                 init_locus_batch,
                                                 init_locus_state,
                                                 topk_from_loci,
                                                 topk_from_loci_batch)
from repro_torch.core.engine.overlay import DeltaOverlay, merge_overlay_topk

__all__ = ["DeviceTrie", "EngineConfig", "INT_MAX", "NEG_ONE",
           "csr_child_lookup", "dedup_pad", "iters_for", "lower_bound",
           "match_table", "teleport_expand", "link_lookup", "finalize_loci",
           "locus_dp", "beam_topk", "cached_topk", "gather_cached",
           "LocusState", "init_locus_state", "advance_locus_state",
           "advance_loci", "init_locus_batch", "advance_loci_batch",
           "topk_from_loci", "topk_from_loci_batch",
           "DeltaOverlay", "merge_overlay_topk",
           "Substrate", "CudaSubstrate", "register_substrate",
           "get_substrate", "available_substrates", "resolve_substrate",
           "topk_phase2", "topk_phase2_batch", "complete_one",
           "complete_batch"]
