"""Note-event decoding from frame rolls (host-side numpy).

Semantics match the reference's `extract_notes_wo_velocity`
(reference task/diffusion.py:1185-1233, duplicated task/utils.py:4-54):
onsets are positive temporal differences of the thresholded onset roll
('rule1' additionally requires the frame roll active at the onset), and
each note extends until the first frame where both rolls are inactive.

The reference scans each note with a Python while-loop; this version is
vectorized — for every pitch it precomputes the sorted positions of
inactive frames and finds each note's offset with a searchsorted, which is
O(notes * log T) instead of O(notes * duration). Results are identical
(tests cross-check against a direct re-implementation of the loop).

Kept on host by design: the computation is sparse and sequential, a poor
fit for the device (SURVEY.md §7 'hard parts').
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def extract_notes(
    onsets: np.ndarray,
    frames: np.ndarray,
    onset_threshold: float = 0.5,
    frame_threshold: float = 0.5,
    rule: str = "rule1",
) -> Tuple[np.ndarray, np.ndarray]:
    """(T, 88) onset/frame activations -> (pitches (N,), intervals (N, 2)).

    Intervals are [onset_frame, offset_frame) indices. The decoder the
    pipeline actually uses passes the same roll for both arguments
    (reference task/diffusion.py:389-404).
    """
    on = np.asarray(onsets) > onset_threshold
    fr = np.asarray(frames) > frame_threshold

    if rule in ("rule1", "rule2"):
        from .. import native

        if native.available():
            out = native.extract_notes(on, fr, rule1=(rule == "rule1"))
            if out is not None:
                return out

    onset_diff = np.concatenate([on[:1], on[1:] & ~on[:-1]], axis=0)
    if rule == "rule1":
        onset_diff &= fr  # require onset AND frame (reference :1208-1210)
    elif rule != "rule2":
        raise NameError("Please enter the correct rule name")

    active = on | fr  # the while-loop condition `onsets or frames`
    t_locs, p_locs = np.nonzero(onset_diff)
    if len(t_locs) == 0:
        return np.empty((0,), np.int64), np.empty((0, 2), np.int64)

    n_t = active.shape[0]
    pitches, intervals = [], []
    # positions of inactive frames per pitch; a note started at `t` ends at
    # the first inactive frame >= t (or T)
    for pitch in np.unique(p_locs):
        inactive = np.nonzero(~active[:, pitch])[0]
        starts = t_locs[p_locs == pitch]
        idx = np.searchsorted(inactive, starts, side="left")
        ends = np.where(idx < len(inactive), inactive[np.minimum(idx, len(inactive) - 1)], n_t)
        for s, e in zip(starts, ends):
            if e > s:
                pitches.append(pitch)
                intervals.append((s, e))

    pitches = np.asarray(pitches, np.int64)
    intervals = np.asarray(intervals, np.int64)
    order = np.lexsort((pitches, intervals[:, 0]))  # by onset, then pitch
    return pitches[order], intervals[order]


def extract_notes_reference_loop(
    onsets: np.ndarray,
    frames: np.ndarray,
    onset_threshold: float = 0.5,
    frame_threshold: float = 0.5,
    rule: str = "rule1",
) -> Tuple[np.ndarray, np.ndarray]:
    """Direct (slow) transcription of the reference while-loop algorithm,
    kept as the oracle for tests."""
    on = (np.asarray(onsets) > onset_threshold).astype(int)
    fr = (np.asarray(frames) > frame_threshold).astype(int)
    onset_diff = np.concatenate([on[:1], on[1:] - on[:-1]], axis=0) == 1
    if rule == "rule1":
        onset_diff = onset_diff & (fr == 1)
    pitches, intervals = [], []
    for t, p in zip(*np.nonzero(onset_diff)):
        off = t
        while on[off, p] or fr[off, p]:
            off += 1
            if off == on.shape[0]:
                break
        if off > t:
            pitches.append(p)
            intervals.append([t, off])
    return np.asarray(pitches, np.int64), np.asarray(intervals, np.int64).reshape(-1, 2)


MIN_MIDI = 21  # piano key 0 == A0 (reference task/diffusion.py:17)


def midi_to_hz(midi) -> np.ndarray:
    return 440.0 * (2.0 ** ((np.asarray(midi, np.float64) - 69.0) / 12.0))


def hz_to_midi(hz) -> np.ndarray:
    return 69.0 + 12.0 * np.log2(np.asarray(hz, np.float64) / 440.0)


def notes_to_hz_seconds(
    pitches: np.ndarray, intervals: np.ndarray, hop_length: int, sample_rate: int
):
    """Frame-index notes -> (intervals seconds, pitches Hz), the unit
    conversion the eval loop applies before scoring
    (reference task/diffusion.py:401-408)."""
    scaling = hop_length / sample_rate
    return intervals.astype(np.float64) * scaling, midi_to_hz(MIN_MIDI + pitches)
