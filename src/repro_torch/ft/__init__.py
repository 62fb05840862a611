"""Fault tolerance (port of ``repro.ft``): the step watchdog."""

from repro_torch.ft.watchdog import StepWatchdog

__all__ = ["StepWatchdog"]
