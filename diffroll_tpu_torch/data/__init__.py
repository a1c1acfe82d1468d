"""Data layer: AMT datasets, rasterization, host pipeline."""

from .amt import MAESTRO, MAPS, PairedAudioMidi
from .custom import Custom, DoubleDataset
from .pipeline import DataLoader, collate, to_device
from .rasterize import rasterize_notes, roll_to_notes

__all__ = [
    "MAPS",
    "MAESTRO",
    "PairedAudioMidi",
    "Custom",
    "DoubleDataset",
    "DataLoader",
    "collate",
    "to_device",
    "rasterize_notes",
    "roll_to_notes",
]
