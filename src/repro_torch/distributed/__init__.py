"""``repro``'s ``distributed`` package as far as it is ported: the fault
tolerance of the training loop.  Sharding, compression and the pipeline
are the mesh routes, ROADMAP.md §1 item 12."""

from repro_torch.distributed import fault_tolerance
from repro_torch.distributed.fault_tolerance import (StragglerWatchdog,
                                                     SupervisorReport,
                                                     TrainSupervisor)

__all__ = ["StragglerWatchdog", "SupervisorReport", "TrainSupervisor",
           "fault_tolerance"]
