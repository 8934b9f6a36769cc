"""The paper's own workloads as serving archs: autocomplete-{dblp,usps,sprot}.

Each arch names a dataset generator of :mod:`repro_torch.data.strings`
and its full size (the paper's Table 1); the launcher
(:mod:`repro_torch.launch.serve`) builds the index from it.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import REGISTRY, ArchSpec, ShapeCell, register
from repro_torch.optim import OptimizerConfig

__all__ = ["ArchSpec", "AutocompleteConfig", "REGISTRY", "DBLP", "USPS",
           "SPROT"]


@dataclass(frozen=True)
class AutocompleteConfig:
    name: str
    n_strings: int
    n_rules: int
    avg_len: int
    index_kind: str = "et"
    cache_k: int = 16


def _shapes(n_strings, n_rules, avg_len, n_shards=16):
    # per-shard trie sizing: nodes ~ strings/shard * distinct-suffix factor
    nodes = max(int(n_strings / n_shards * avg_len * 0.4), 1024)
    return {
        "serve_1k": ShapeCell("serve_1k", "serve", {
            "batch": 1024, "query_len": 32, "k": 10,
            "nodes_per_shard": nodes, "edges_per_shard": nodes,
            "rule_nodes": n_rules * 8, "rules": n_rules, "cache_k": 16}),
    }


def _make(name, n_strings, n_rules, avg_len) -> ArchSpec:
    cfg = AutocompleteConfig(name, n_strings, n_rules, avg_len)
    return register(ArchSpec(
        arch_id=f"autocomplete-{name}", family="autocomplete",
        source="this paper (CS.IR 2016), Table 1",
        make_config=lambda: cfg,
        make_smoke_config=lambda: AutocompleteConfig(
            name + "-smoke", 500, 24, avg_len),
        shapes=_shapes(n_strings, n_rules, avg_len),
        optimizer=OptimizerConfig(name="sgd"),
        notes="construction is offline (Alg.1/3/5)"))


DBLP = _make("dblp", 24_810, 368, 60)
USPS = _make("usps", 1_000_000, 341, 25)
SPROT = _make("sprot", 1_000_000, 1_000, 20)
