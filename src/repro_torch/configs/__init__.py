"""Architecture registry of the port: the three autocomplete archs and the
five LM archs.

The JAX package's recsys and GNN archs are named here only so that asking
for one raises ``NotImplementedError`` with its ROADMAP item, not an
unknown-arch error.
"""

from repro_torch.configs import (arctic_480b, autocomplete,  # noqa: F401
                                 granite_moe_1b_a400m, h2o_danube_1_8b,
                                 mistral_nemo_12b, qwen2_5_14b)
from repro_torch.configs.autocomplete import AutocompleteConfig
from repro_torch.configs.base import REGISTRY, ArchSpec, ShapeCell
from repro_torch.not_ported import not_ported

#: the JAX package's arch ids the port does not run yet (recsys and GNN)
OTHER_ARCHS = ("gin-tu", "mind", "sasrec", "din", "dlrm-rm2")
#: the LM archs, in the JAX package's order
LM_ARCHS = ("granite-moe-1b-a400m", "arctic-480b", "mistral-nemo-12b",
            "h2o-danube-1.8b", "qwen2.5-14b")


def all_archs() -> dict[str, ArchSpec]:
    return dict(REGISTRY)


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id in REGISTRY:
        return REGISTRY[arch_id]
    if arch_id in OTHER_ARCHS:
        raise not_ported("arch")
    raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(REGISTRY)}")


__all__ = ["ArchSpec", "AutocompleteConfig", "LM_ARCHS", "OTHER_ARCHS",
           "REGISTRY", "ShapeCell", "all_archs", "get_arch"]
