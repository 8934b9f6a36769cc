"""Optimizers (``repro``'s ``optim``): AdamW, Adafactor and SGD as plain
functions on trees of tensors, the warmup + cosine schedule, global-norm
clipping, and the state carried to and from ``repro``'s arrays."""

from repro_torch.optim.optimizers import (OptimizerConfig, apply_updates,
                                          clip_by_global_norm, global_norm,
                                          grad_tree, init_optimizer, lr_at,
                                          opt_state_from_numpy,
                                          opt_state_to_numpy)

__all__ = ["OptimizerConfig", "apply_updates", "clip_by_global_norm",
           "global_norm", "grad_tree", "init_optimizer", "lr_at",
           "opt_state_from_numpy", "opt_state_to_numpy"]
