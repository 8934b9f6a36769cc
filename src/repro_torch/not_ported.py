"""Options and surfaces of the JAX package that the port does not run yet.

Each raises ``NotImplementedError`` naming the ROADMAP.md §1 item that
ports it; none runs quietly on a plain version.
"""

from __future__ import annotations

_ITEMS = {
    "arch": (12, "the recsys and GNN archs (their models, training and "
                 "serving)"),
    "lm_training": (12, "LM training's pieces (the loss, the optimizers "
                        "and the mesh routes)"),
}


def not_ported(feature: str) -> NotImplementedError:
    item, what = _ITEMS[feature]
    return NotImplementedError(
        f"{what} are not ported yet; see ROADMAP.md §1 item {item}")
