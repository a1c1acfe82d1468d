from .baseline import BaselineConfig, BaselineTask
from .diffusion import DiffusionTask, TaskConfig
from .transcribe import split_windows, stitch_rolls, transcribe_long

__all__ = ["BaselineConfig", "BaselineTask", "DiffusionTask", "TaskConfig", "split_windows",
           "stitch_rolls", "transcribe_long"]
