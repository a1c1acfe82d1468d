from .mel import MelConfig, MelSpectrogram, log_mel
from .normalize import min_max_normalize

__all__ = ["MelConfig", "MelSpectrogram", "log_mel", "min_max_normalize"]
