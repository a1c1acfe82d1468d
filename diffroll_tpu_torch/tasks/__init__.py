from .diffusion import DiffusionTask, TaskConfig
from .transcribe import split_windows, stitch_rolls, transcribe_long

__all__ = ["DiffusionTask", "TaskConfig", "split_windows", "stitch_rolls",
           "transcribe_long"]
