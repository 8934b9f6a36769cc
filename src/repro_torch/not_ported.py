"""Surfaces of the JAX package that the port does not run yet.

Each raises ``NotImplementedError`` naming the ROADMAP.md §1 item that
ports it; none runs quietly on a plain version.
"""

from __future__ import annotations

_ITEMS = {
    "mesh": (12, "the mesh routes (sharded gradients and optimizer state, "
                 "elastic re-sharding, a multi-process training launch)"),
}


def not_ported(feature: str) -> NotImplementedError:
    item, what = _ITEMS[feature]
    return NotImplementedError(
        f"{what} is not ported yet; see ROADMAP.md §1 item {item}")
