"""Core: the paper's contribution — synonym-aware top-k string completion."""

from repro_torch.core.engine import DeviceTrie, EngineConfig
from repro_torch.core.oracle import OracleIndex
from repro_torch.core.trie_build import SynonymRule, make_rules

# The index layer lives in repro_torch.api, which itself builds on the
# submodules above: its names resolve lazily (PEP 562), so importing
# repro_torch.core.trie_build from repro_torch.api does not recurse
# through this package.  They resolve from repro_torch.api, not from the
# deprecated repro_torch.core.api shim, so they do not warn.
_API_NAMES = ("BuildStats", "CompletionIndex", "IndexSpec", "Session",
              "build_index")

__all__ = ["BuildStats", "CompletionIndex", "DeviceTrie", "EngineConfig",
           "IndexSpec", "OracleIndex", "Session", "SynonymRule",
           "build_index", "make_rules"]


def __getattr__(name):
    if name in _API_NAMES:
        from repro_torch import api as _api
        return getattr(_api, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
