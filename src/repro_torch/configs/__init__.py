"""Architecture registry of the port: the three autocomplete archs.

The JAX package's other archs (its LM, recsys and GNN models) are named
here only so that asking for one raises ``NotImplementedError`` with its
ROADMAP item, not an unknown-arch error.
"""

from repro_torch.configs.autocomplete import (REGISTRY, ArchSpec,
                                              AutocompleteConfig)
from repro_torch.not_ported import not_ported

#: the JAX package's arch ids outside the autocomplete family
OTHER_ARCHS = ("granite-moe-1b-a400m", "arctic-480b", "mistral-nemo-12b",
               "h2o-danube-1.8b", "qwen2.5-14b", "gin-tu", "mind",
               "sasrec", "din", "dlrm-rm2")


def all_archs() -> dict[str, ArchSpec]:
    return dict(REGISTRY)


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id in REGISTRY:
        return REGISTRY[arch_id]
    if arch_id in OTHER_ARCHS:
        raise not_ported("arch")
    raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(REGISTRY)}")


__all__ = ["ArchSpec", "AutocompleteConfig", "OTHER_ARCHS", "REGISTRY",
           "all_archs", "get_arch"]
