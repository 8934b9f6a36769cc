"""repro_torch.api — the public completion-index surface."""

from repro_torch.api.build import BuildStats, build_index
from repro_torch.api.index import CompletionIndex
from repro_torch.api.persist import load_index
from repro_torch.api.spec import IndexSpec, registered_kinds

__all__ = ["BuildStats", "CompletionIndex", "IndexSpec", "build_index",
           "load_index", "registered_kinds"]
