"""The completion engine on tensors: structures, the two phases (and the
incremental phase 1 of a typing session), the substrates that run them,
and the delta overlay that merges online mutations into their top-k."""

from repro_torch.core.engine.structs import (DeviceTrie, EngineConfig,
                                             INT_MAX, NEG_ONE)
from repro_torch.core.engine.substrate import (available_substrates,
                                               complete_batch, complete_one,
                                               get_substrate,
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
           "available_substrates", "complete_batch", "complete_one",
           "get_substrate", "resolve_substrate", "topk_phase2",
           "topk_phase2_batch",
           "LocusState", "init_locus_state", "advance_locus_state",
           "advance_loci", "init_locus_batch", "advance_loci_batch",
           "topk_from_loci", "topk_from_loci_batch",
           "DeltaOverlay", "merge_overlay_topk"]
