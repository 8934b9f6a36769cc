"""repro_torch — the completion engine ported to PyTorch and CUDA.

The JAX package ``repro`` is the reference; this package mirrors its
layout and names.  Entry points (:func:`build_index`, :func:`load_index`,
:class:`ShardedCompletionIndex`, :class:`CompletionService`, and LM
serving's ``models.transformer.init_lm`` behind ``serving.LMServer``) run
on the CUDA device unless the caller passes ``device="cpu"``.
"""

from repro_torch.api import (CompletionIndex, IndexSpec, Session,
                             build_index, load_index)
from repro_torch.core.distributed import (ShardedCompletionIndex,
                                          UnsupportedOnShardedIndex)
from repro_torch.serving import (BatchSession, BatchStats, CompletionService,
                                 KeystrokeScheduler, SchedulerOverloaded,
                                 ServiceSession, ServiceStats, Ticket)

__all__ = ["BatchSession", "BatchStats", "CompletionIndex",
           "CompletionService", "IndexSpec", "KeystrokeScheduler",
           "SchedulerOverloaded", "ServiceSession", "ServiceStats",
           "Session", "ShardedCompletionIndex", "Ticket",
           "UnsupportedOnShardedIndex", "build_index", "load_index"]
