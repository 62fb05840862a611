"""Resilience layer (port of ``repro.resilience``): deterministic fault
injection (:mod:`repro_torch.resilience.faults`, seeded
:class:`FaultPlan` schedules behind named host-side sites, from
``REPRO_FAULT_PLAN`` or :func:`faults.use_plan`) and stream checkpoints
(:mod:`repro_torch.resilience.checkpoint`, :class:`StreamCheckpoint`
behind ``lasana.stream(checkpoint_every=)`` and ``lasana.resume``)."""

from repro_torch.resilience.checkpoint import (CKPT_FORMAT_VERSION,
                                               StreamCheckpoint, spec_key_of)
from repro_torch.resilience.faults import (FAULT_SITES, FaultInjected,
                                           FaultPlan, SiteSchedule,
                                           active_plan, use_plan)

__all__ = [
    "CKPT_FORMAT_VERSION",
    "FAULT_SITES",
    "FaultInjected",
    "FaultPlan",
    "SiteSchedule",
    "StreamCheckpoint",
    "active_plan",
    "spec_key_of",
    "use_plan",
]
