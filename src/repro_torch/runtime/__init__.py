"""Fault-tolerance runtime: health tracking, straggler detection, restart
(the port's counterpart of ``repro.runtime``)."""
from .health import HealthMonitor, StepTimer, StragglerWatchdog
from .supervisor import Supervisor, SupervisorConfig

__all__ = ["HealthMonitor", "StepTimer", "StragglerWatchdog",
           "Supervisor", "SupervisorConfig"]
