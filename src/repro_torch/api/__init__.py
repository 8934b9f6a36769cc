"""repro_torch.api — the public completion-index surface."""

from repro_torch.api.build import BuildStats, build_index, multiterm_rules
from repro_torch.api.compile_cache import CompileCache, bucket_size
from repro_torch.api.index import CompletionIndex
from repro_torch.api.persist import load_index, save_index
from repro_torch.api.session import Session
from repro_torch.api.spec import (IndexSpec, get_builder, get_synthesizer,
                                  register_builder,
                                  register_rule_synthesizer,
                                  registered_kinds)

__all__ = ["BuildStats", "CompileCache", "CompletionIndex", "IndexSpec",
           "Session", "bucket_size", "build_index", "get_builder",
           "get_synthesizer", "load_index", "multiterm_rules",
           "register_builder", "register_rule_synthesizer",
           "registered_kinds", "save_index"]
