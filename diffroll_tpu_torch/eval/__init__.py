"""Evaluation: note decoding (the F1 metrics and batch scoring of the JAX
package are not ported yet)."""

from .notes import (
    MIN_MIDI,
    extract_notes,
    hz_to_midi,
    midi_to_hz,
    notes_to_hz_seconds,
)

__all__ = [
    "extract_notes",
    "notes_to_hz_seconds",
    "midi_to_hz",
    "hz_to_midi",
    "MIN_MIDI",
]
