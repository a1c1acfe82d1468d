from .logging import MetricLogger
from .profiling import StepTimer, trace_if

__all__ = ["MetricLogger", "StepTimer", "trace_if"]
