"""The LM's layers and the transformer (``repro``'s ``models`` package,
its serving half; the recsys and GNN models are ROADMAP.md §1 item 12)."""

from repro_torch.models import layers, transformer

__all__ = ["layers", "transformer"]
