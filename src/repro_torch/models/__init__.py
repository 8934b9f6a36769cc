"""The serving half of ``repro``'s ``models`` package: the LM's layers and
the transformer, the recsys models and GIN (their training is ROADMAP.md
§1 item 12)."""

from repro_torch.models import gnn, layers, recsys, transformer

__all__ = ["gnn", "layers", "recsys", "transformer"]
