"""Kernel sanitizer: static analysis of the invariants the port's kernel
and cache layers keep by convention.

Nothing at run time checks that every ``EngineConfig`` field a cached
entry point reads rides its compile-cache key, or that a launch's dynamic
shared memory comes from its kernel's launch plan and is held under the
card's limit there: a stale key or a short buffer is a silent wrong
result.  This package checks them over the AST, without importing (let
alone running) the checked code.  The port's counterpart of
``repro.analysis``, with two rule families (see the rule modules):

- :mod:`repro_torch.analysis.cachekey` — ``KEY001``-``KEY002``: compile-
  cache key completeness and a config that hashes by value (``repro``'s
  ``KEY003`` has no counterpart: the port has no ``static_argnames``);
- :mod:`repro_torch.analysis.shm` — ``SHM001``-``SHM002``: dynamic shared
  memory made by the launch plans and checked against the card's limit
  (in place of ``repro``'s VMEM envelope rules ``ENV001``-``ENV004``).

``repro``'s ``DMA001``-``DMA004`` and ``TRC001``-``TRC002`` have no
counterpart: the kernels are CUDA C++, not traced Python, and the card
has no DMA-streamed tier.

Run it as ``python -m repro_torch.analysis`` (add ``--fail-on-findings``
for the gate).  A finding on a line carrying, or directly below, a waiver
comment ``# sanitizer: waive[RULE-ID] <reason>`` is suppressed; the reason
is mandatory (a waiver without one is reported as ``WAIV01``) and the
waiver covers one rule id (or ``*``).
"""

from __future__ import annotations

from repro_torch.analysis.findings import Finding, Waiver, scan_waivers
from repro_torch.analysis.runner import run_all

__all__ = ["Finding", "Waiver", "run_all", "scan_waivers"]
