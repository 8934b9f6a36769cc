"""Deprecated shim: the public API is :mod:`repro_torch.api`.

Importing this module warns, as ``repro.core.api`` does; the re-exports
below keep ``from repro_torch.core.api import CompletionIndex`` working.
New code imports from ``repro_torch.api``, or from ``repro_torch.core``,
whose lazy attributes resolve there without touching this shim.
"""

import warnings

warnings.warn(
    "repro_torch.core.api is deprecated and will be removed; import from "
    "repro_torch.api instead (e.g. `from repro_torch.api import "
    "CompletionIndex`)", DeprecationWarning, stacklevel=2)

from repro_torch.api.build import BuildStats, build_index  # noqa: E402
from repro_torch.api.index import CompletionIndex, _to_device  # noqa: E402
from repro_torch.api.session import Session  # noqa: E402
from repro_torch.api.spec import IndexSpec  # noqa: E402

__all__ = ["BuildStats", "CompletionIndex", "IndexSpec", "Session",
           "build_index", "_to_device"]
