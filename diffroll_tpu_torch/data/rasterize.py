"""MIDI note events -> piano-roll labels.

Re-implements the rasterization contract of the external
`AudioLoader.music.amt` datasets the reference trains on (reference
requirements.txt:9; consumed via batch["frame"] (B, 640, 88) at
task/diffusion.py:652-653, config/dataset/MAPS.yaml): frame rolls at
`hop_length` samples per frame, MIDI pitches `min_midi..max_midi` mapped to
roll columns 0..87, following the standard Onsets-and-Frames convention:

  frame_roll[t, p] = 1  iff  note p sounds within frame t, where a note
  with onset/offset in seconds occupies frames
  [round(onset*sr/hop), round(offset*sr/hop)).

An onset roll (first frame of each note) is produced alongside for
decoders/datasets that want it.
"""

from __future__ import annotations

from typing import Iterable, Tuple

import numpy as np

from ..io.midi import MidiNote


def rasterize_notes(
    notes: Iterable[MidiNote],
    n_frames: int,
    hop_length: int = 512,
    sample_rate: int = 16000,
    min_midi: int = 21,
    max_midi: int = 108,
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (frame_roll, onset_roll), both (n_frames, max-min+1) float32."""
    notes = list(notes)
    return rasterize_arrays(
        np.array([n.onset for n in notes], np.float64),
        np.array([n.offset for n in notes], np.float64),
        np.array([n.pitch for n in notes], np.int64),
        n_frames, hop_length, sample_rate, min_midi, max_midi,
    )


def rasterize_arrays(
    onsets: np.ndarray,
    offsets: np.ndarray,
    pitches: np.ndarray,
    n_frames: int,
    hop_length: int = 512,
    sample_rate: int = 16000,
    min_midi: int = 21,
    max_midi: int = 108,
    frame_offset: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Array-in variant — the loader hot path: per-clip note arrays are
    cached once and each window rasterizes them directly, with no per-note
    Python objects.

    `frame_offset` rasterizes the window starting at that ABSOLUTE frame:
    rounding happens on the absolute frame grid first, then the integer
    offset is subtracted, so a window's roll is bit-identical to the
    matching slice of the full-clip roll. (Subtracting the start *time*
    from the onsets instead shifts exact .5-frame boundaries by float
    error and flips boundary frames.)"""
    from .. import native

    if frame_offset:
        fps = sample_rate / hop_length
        f0a = np.floor(np.asarray(onsets) * fps + 0.5) - frame_offset
        f1a = np.floor(np.asarray(offsets) * fps + 0.5) - frame_offset
        # re-encode as frame-centered times: floor(t*fps + 0.5) recovers
        # the integer exactly for both the numpy and the C path
        onsets = (f0a + 0.25) / fps
        offsets = (f1a + 0.25) / fps

    if len(onsets) and native.available():
        out = native.rasterize(
            onsets, offsets, pitches,
            n_frames, hop_length, sample_rate, min_midi, max_midi,
        )
        if out is not None:
            return out

    n_pitches = max_midi - min_midi + 1
    frame = np.zeros((n_frames, n_pitches), np.float32)
    onset = np.zeros((n_frames, n_pitches), np.float32)
    if len(onsets) == 0:
        return frame, onset
    fps = sample_rate / hop_length
    # half-UP rounding: Python's round() is half-to-even, which makes
    # rasterization inconsistent under integer frame shifts (a window's
    # roll would disagree with the matching slice of the full roll)
    f0 = np.floor(np.asarray(onsets) * fps + 0.5).astype(np.int64)
    f1 = np.floor(np.asarray(offsets) * fps + 0.5).astype(np.int64)
    f1 = np.maximum(f1, f0 + 1)  # a note always occupies >= 1 frame
    p = np.asarray(pitches, np.int64) - min_midi
    keep = ((p >= 0) & (p < n_pitches) & (f0 < n_frames) & (f1 > 0))
    f0k, f1k, pk = f0[keep], f1[keep], p[keep]
    # range fill via a +1/-1 difference array and a cumulative sum — one
    # O(n_frames x pitches) pass regardless of note count/length
    diff = np.zeros((n_frames + 1, n_pitches), np.int32)
    np.add.at(diff, (np.maximum(f0k, 0), pk), 1)
    np.add.at(diff, (np.minimum(f1k, n_frames), pk), -1)
    frame = (np.cumsum(diff[:-1], axis=0) > 0).astype(np.float32)
    vis = (f0k >= 0) & (f0k < n_frames)
    onset[f0k[vis], pk[vis]] = 1.0
    return frame, onset


def roll_to_notes(
    frame_roll: np.ndarray,
    hop_length: int = 512,
    sample_rate: int = 16000,
    min_midi: int = 21,
    threshold: float = 0.5,
):
    """Inverse for tests/tools: binarized roll -> MidiNote list."""
    from ..eval.notes import extract_notes

    pitches, intervals = extract_notes(frame_roll, frame_roll, threshold, threshold)
    scale = hop_length / sample_rate
    return [
        MidiNote(onset=i0 * scale, offset=i1 * scale, pitch=int(p) + min_midi,
                 velocity=100)
        for p, (i0, i1) in zip(pitches, intervals)
    ]
