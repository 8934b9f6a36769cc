"""Surfaces of the JAX package that the port does not run yet.

Each raises ``NotImplementedError`` naming the ROADMAP.md §1 item that
ports it; none runs quietly on a plain version.
"""

from __future__ import annotations

_ITEMS = {
    "training": (12, "training (the LM's, recsys and GNN losses, the "
                     "optimizers and the mesh routes)"),
}


def not_ported(feature: str) -> NotImplementedError:
    item, what = _ITEMS[feature]
    return NotImplementedError(
        f"{what} is not ported yet; see ROADMAP.md §1 item {item}")
