"""Evaluation: note decoding, frame and note F1, batch scoring (the port's
copies of the JAX package's numpy modules)."""

from .evaluate import evaluate_rolls
from .f1 import frame_metrics, match_notes, note_metrics
from .notes import (
    MIN_MIDI,
    extract_notes,
    hz_to_midi,
    midi_to_hz,
    notes_to_hz_seconds,
)

__all__ = [
    "evaluate_rolls",
    "frame_metrics",
    "note_metrics",
    "match_notes",
    "extract_notes",
    "notes_to_hz_seconds",
    "midi_to_hz",
    "hz_to_midi",
    "MIN_MIDI",
]
