"""Hardened serving stack: scheduler (admission/deadlines/retry) and engine
(slot pool, invariant checks, degrade ladder). See docs/serving.md."""
from repro_torch.serving.engine import DegradeLadder, ServingEngine
from repro_torch.serving.scheduler import (Request, RejectReason, Scheduler,
                                           State)

__all__ = ["DegradeLadder", "Request", "RejectReason", "Scheduler",
           "ServingEngine", "State"]
