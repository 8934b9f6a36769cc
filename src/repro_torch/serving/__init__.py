"""The serving front-end: the completion service, the keystroke scheduler
and the continuous-batching LM server."""

from repro_torch.serving.completion_service import (CompletionService,
                                                    ServiceSession,
                                                    ServiceStats)
from repro_torch.serving.engine import LMServer, Request, SlotScheduler
from repro_torch.serving.scheduler import (BatchSession, BatchStats,
                                           KeystrokeScheduler,
                                           SchedulerOverloaded, Ticket)

__all__ = ["CompletionService", "ServiceSession", "ServiceStats", "LMServer",
           "Request", "SlotScheduler", "KeystrokeScheduler", "BatchSession",
           "BatchStats", "SchedulerOverloaded", "Ticket"]
