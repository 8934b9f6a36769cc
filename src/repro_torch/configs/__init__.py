"""Architecture registry of the port: the ten archs ``repro`` assigns (five
LM, four recsys, one GNN) and the three autocomplete archs."""

from repro_torch.configs import (arctic_480b, autocomplete, din,  # noqa: F401
                                 dlrm_rm2, gin_tu, granite_moe_1b_a400m,
                                 h2o_danube_1_8b, mind, mistral_nemo_12b,
                                 qwen2_5_14b, sasrec)
from repro_torch.configs.autocomplete import AutocompleteConfig
from repro_torch.configs.base import REGISTRY, ArchSpec, ShapeCell

#: the LM archs, in the JAX package's order
LM_ARCHS = ("granite-moe-1b-a400m", "arctic-480b", "mistral-nemo-12b",
            "h2o-danube-1.8b", "qwen2.5-14b")
#: the recsys archs, in the JAX package's order, and the GNN arch
RECSYS_ARCHS = ("mind", "sasrec", "din", "dlrm-rm2")
GNN_ARCHS = ("gin-tu",)
#: ``repro``'s ``configs.registry.ASSIGNED``
ASSIGNED = LM_ARCHS + GNN_ARCHS + RECSYS_ARCHS


def all_archs() -> dict[str, ArchSpec]:
    return dict(REGISTRY)


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id in REGISTRY:
        return REGISTRY[arch_id]
    raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(REGISTRY)}")


__all__ = ["ASSIGNED", "ArchSpec", "AutocompleteConfig", "GNN_ARCHS",
           "LM_ARCHS", "RECSYS_ARCHS", "REGISTRY", "ShapeCell", "all_archs",
           "get_arch"]
