"""Optimizer settings the arch specs carry.

Only :class:`OptimizerConfig` is ported: the LM specs name one.  The
optimizers themselves (``init_optimizer``, ``apply_updates``, ``lr_at``)
belong to LM training, ROADMAP.md §1 item 12.
"""

from repro_torch.optim.optimizers import OptimizerConfig

__all__ = ["OptimizerConfig"]
