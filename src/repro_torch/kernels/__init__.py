"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version; see ``_build`` for how they are compiled and bound.

- trie_walk:       batched longest-prefix trie descent (rule-free phase 1)
- locus_dp:        fused synonym-aware locus DP (tt/et/ht phase 1, dense
                   and packed, edit budget 0-2)
- beam_topk:       fused beam phase 2 (the generator-pool priority search)
- topk_select:     top-k with payload (merge points)
- locus_merge:     cached-top-K locus gather + merge (the cached phase 2)
- embedding_bag:   ragged gather + segment reduce (recsys)
- candidate_topk:  fused dot scoring + top-k (retrieval)

The engine reaches them through its ``cuda`` substrate (see
:mod:`repro_torch.core.engine.substrate`); ``ops`` holds the public
wrappers under ``repro.kernels.ops``'s names and ``ref`` the plain
versions under ``repro.kernels.ref``'s.
"""

from repro_torch.kernels import ops, ref

__all__ = ["ops", "ref"]
