"""The serving front-end: the completion service and the keystroke
scheduler."""

from repro_torch.serving.completion_service import (CompletionService,
                                                    ServiceSession,
                                                    ServiceStats)
from repro_torch.serving.scheduler import (BatchSession, BatchStats,
                                           KeystrokeScheduler,
                                           SchedulerOverloaded, Ticket)

__all__ = ["CompletionService", "ServiceSession", "ServiceStats",
           "KeystrokeScheduler", "BatchSession", "BatchStats",
           "SchedulerOverloaded", "Ticket"]
