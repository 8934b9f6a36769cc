"""The paper's own workloads as serving archs: autocomplete-{dblp,usps,sprot}.

Each arch names a dataset generator of :mod:`repro_torch.data.strings`
and its full size (the paper's Table 1); the launcher
(:mod:`repro_torch.launch.serve`) builds the index from it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable


@dataclass(frozen=True)
class AutocompleteConfig:
    name: str
    n_strings: int
    n_rules: int
    avg_len: int
    index_kind: str = "et"
    cache_k: int = 16


@dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str               # autocomplete (the only family ported)
    source: str
    make_config: Callable[[], Any]
    make_smoke_config: Callable[[], Any]
    notes: str = ""


REGISTRY: dict[str, ArchSpec] = {}


def _make(name, n_strings, n_rules, avg_len) -> ArchSpec:
    cfg = AutocompleteConfig(name, n_strings, n_rules, avg_len)
    spec = ArchSpec(
        arch_id=f"autocomplete-{name}", family="autocomplete",
        source="this paper (CS.IR 2016), Table 1",
        make_config=lambda: cfg,
        make_smoke_config=lambda: AutocompleteConfig(
            name + "-smoke", 500, 24, avg_len),
        notes="construction is offline (Alg.1/3/5)")
    REGISTRY[spec.arch_id] = spec
    return spec


DBLP = _make("dblp", 24_810, 368, 60)
USPS = _make("usps", 1_000_000, 341, 25)
SPROT = _make("sprot", 1_000_000, 1_000, 20)
