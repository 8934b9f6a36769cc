"""The completion engine on tensors: structures, the two phases, and the
substrates that run them."""

from repro_torch.core.engine.structs import (DeviceTrie, EngineConfig,
                                             INT_MAX, NEG_ONE)
from repro_torch.core.engine.substrate import (available_substrates,
                                               complete_batch, get_substrate,
                                               resolve_substrate)

__all__ = ["DeviceTrie", "EngineConfig", "INT_MAX", "NEG_ONE",
           "available_substrates", "complete_batch", "get_substrate",
           "resolve_substrate"]
