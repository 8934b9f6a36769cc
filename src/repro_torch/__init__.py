"""repro_torch — the completion engine ported to PyTorch and CUDA.

The JAX package ``repro`` is the reference; this package mirrors its
layout and names.  Entry points (:func:`build_index`, :func:`load_index`,
:class:`CompletionService`) run on the CUDA device unless the caller passes
``device="cpu"``.
"""

from repro_torch.api import (CompletionIndex, IndexSpec, Session,
                             build_index, load_index)
from repro_torch.serving.completion_service import CompletionService

__all__ = ["CompletionIndex", "CompletionService", "IndexSpec", "Session",
           "build_index", "load_index"]
