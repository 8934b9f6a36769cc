"""Architecture registry: ArchSpec + shape cells (the data of ``repro``'s
``configs/base.py``).

Every ported arch registers an :class:`ArchSpec`; the launcher selects
one with ``--arch``.  A shape cell is one input shape of an arch.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

from repro_torch.optim import OptimizerConfig


@dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str                 # train | prefill | decode | serve | retrieval
    params: dict
    skip: str | None = None   # reason when the cell is skipped (documented)


@dataclass
class ArchSpec:
    arch_id: str
    family: str               # lm | gnn | recsys | autocomplete
    source: str
    make_config: Callable[[], Any]
    make_smoke_config: Callable[[], Any]
    shapes: dict[str, ShapeCell]
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    notes: str = ""


REGISTRY: dict[str, ArchSpec] = {}


def register(spec: ArchSpec) -> ArchSpec:
    REGISTRY[spec.arch_id] = spec
    return spec


LM_SHAPES = {
    "train_4k": ShapeCell("train_4k", "train",
                          {"seq": 4096, "batch": 256}),
    "prefill_32k": ShapeCell("prefill_32k", "prefill",
                             {"seq": 32768, "batch": 32}),
    "decode_32k": ShapeCell("decode_32k", "decode",
                            {"seq": 32768, "batch": 128}),
    "long_500k": ShapeCell("long_500k", "decode",
                           {"seq": 524288, "batch": 1}),
}


def lm_shapes(long_ctx_ok: bool, skip_reason: str = "") -> dict[str, ShapeCell]:
    out = dict(LM_SHAPES)
    if not long_ctx_ok:
        c = out["long_500k"]
        out["long_500k"] = ShapeCell(c.name, c.kind, c.params,
                                     skip=skip_reason or
                                     "pure full-attention arch: 512k decode "
                                     "requires sub-quadratic attention "
                                     "(DESIGN §4.1)")
    return out


RECSYS_SHAPES = {
    "train_batch": ShapeCell("train_batch", "train", {"batch": 65536}),
    "serve_p99": ShapeCell("serve_p99", "serve", {"batch": 512}),
    "serve_bulk": ShapeCell("serve_bulk", "serve", {"batch": 262144}),
    "retrieval_cand": ShapeCell("retrieval_cand", "retrieval",
                                {"batch": 1, "n_candidates": 1_000_000}),
}

GNN_SHAPES = {
    "full_graph_sm": ShapeCell(
        "full_graph_sm", "train",
        {"n_nodes": 2708, "n_edges": 10556, "d_feat": 1433, "n_classes": 7}),
    "minibatch_lg": ShapeCell(
        "minibatch_lg", "train",
        {"n_nodes": 232_965, "n_edges": 114_615_892, "batch_nodes": 1024,
         "fanout": (15, 10), "d_feat": 602, "n_classes": 41}),
    "ogb_products": ShapeCell(
        "ogb_products", "train",
        {"n_nodes": 2_449_029, "n_edges": 61_859_140, "d_feat": 100,
         "n_classes": 47}),
    "molecule": ShapeCell(
        "molecule", "train",
        {"n_nodes": 30, "n_edges": 64, "batch": 128, "d_feat": 32,
         "n_classes": 2}),
}
