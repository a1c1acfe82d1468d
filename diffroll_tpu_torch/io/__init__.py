"""Host-side I/O: MIDI files, WAV audio. Pure Python + numpy (the image has
no mido/torchaudio/soundfile; these replace them for this framework)."""

from .midi import MidiNote, read_midi, write_midi
from .wav import read_wav, resample, write_wav

__all__ = ["MidiNote", "read_midi", "write_midi", "read_wav", "write_wav", "resample"]
