"""``repro``'s ``models`` package on one device: the LM's layers and the
transformer, the recsys models and GIN, each with its loss (the mesh
routes are ROADMAP.md §1 item 12)."""

from repro_torch.models import gnn, layers, recsys, transformer

__all__ = ["gnn", "layers", "recsys", "transformer"]
