"""Frame- and note-level precision/recall/F1 (the port's copy of
`diffroll_tpu/eval/f1.py`, numpy and scipy only).

Frame metrics re-implement sklearn's binary precision_recall_fscore on
flattened thresholded rolls (reference task/diffusion.py:381-383). Note
metrics re-implement mir_eval.transcription.precision_recall_f1_overlap
with offset_ratio=None (onset-only matching, 50 ms tolerance, 50-cent
pitch tolerance, maximum bipartite matching) — the exact protocol of the
reference eval (reference task/diffusion.py:410; mir_eval is not available
in this environment, so the matcher is implemented here and property-tested
against a brute-force oracle).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def frame_metrics(
    pred: np.ndarray, label: np.ndarray, threshold: float
) -> Dict[str, float]:
    """Binary P/R/F1 over all flattened cells."""
    p = np.asarray(pred).reshape(-1) > threshold
    l = np.asarray(label).reshape(-1) > 0.5
    tp = float(np.sum(p & l))
    fp = float(np.sum(p & ~l))
    fn = float(np.sum(~p & l))
    precision = tp / (tp + fp) if tp + fp else 0.0
    recall = tp / (tp + fn) if tp + fn else 0.0
    f1 = 2 * precision * recall / (precision + recall) if precision + recall else 0.0
    return {"precision": precision, "recall": recall, "f1": f1}


def match_notes(
    ref_intervals: np.ndarray,
    ref_pitches_hz: np.ndarray,
    est_intervals: np.ndarray,
    est_pitches_hz: np.ndarray,
    onset_tolerance: float = 0.05,
    pitch_tolerance_cents: float = 50.0,
    offset_ratio: float | None = None,
    offset_min_tolerance: float = 0.05,
) -> list[Tuple[int, int]]:
    """Maximum bipartite matching between reference and estimated notes.

    A pair is a candidate iff |onset difference| <= onset_tolerance and
    |pitch difference| < pitch_tolerance_cents. With offset_ratio set, the
    offsets must also agree within max(offset_ratio * ref_duration,
    offset_min_tolerance) — mir_eval's full contract; the reference eval
    uses offset_ratio=None.
    """
    n_ref, n_est = len(ref_pitches_hz), len(est_pitches_hz)
    if n_ref == 0 or n_est == 0:
        return []

    onset_ok = (
        np.abs(ref_intervals[:, 0][:, None] - est_intervals[:, 0][None, :])
        <= onset_tolerance
    )
    cents = 1200.0 * np.abs(
        np.log2(est_pitches_hz[None, :] / ref_pitches_hz[:, None])
    )
    ok = onset_ok & (cents < pitch_tolerance_cents)
    if offset_ratio is not None:
        dur = ref_intervals[:, 1] - ref_intervals[:, 0]
        tol = np.maximum(offset_ratio * dur, offset_min_tolerance)
        ok &= (
            np.abs(ref_intervals[:, 1][:, None] - est_intervals[:, 1][None, :])
            <= tol[:, None]
        )

    if not ok.any():
        return []
    from scipy.optimize import linear_sum_assignment

    # maximum-cardinality matching via assignment on a 0/1 profit matrix
    rows, cols = linear_sum_assignment(ok.astype(np.float64), maximize=True)
    return [(int(r), int(c)) for r, c in zip(rows, cols) if ok[r, c]]


def note_metrics(
    ref_intervals: np.ndarray,
    ref_pitches_hz: np.ndarray,
    est_intervals: np.ndarray,
    est_pitches_hz: np.ndarray,
    onset_tolerance: float = 0.05,
    offset_ratio: float | None = None,
) -> Dict[str, float]:
    """precision_recall_f1_overlap equivalent. Returns p/r/f1 and the mean
    overlap ratio of matched pairs."""
    matches = match_notes(
        ref_intervals, ref_pitches_hz, est_intervals, est_pitches_hz,
        onset_tolerance=onset_tolerance, offset_ratio=offset_ratio,
    )
    n_ref, n_est = len(ref_pitches_hz), len(est_pitches_hz)
    precision = len(matches) / n_est if n_est else 0.0
    recall = len(matches) / n_ref if n_ref else 0.0
    f1 = 2 * precision * recall / (precision + recall) if precision + recall else 0.0
    if matches:
        overlaps = []
        for r, e in matches:
            start = max(ref_intervals[r, 0], est_intervals[e, 0])
            end = min(ref_intervals[r, 1], est_intervals[e, 1])
            span = max(ref_intervals[r, 1], est_intervals[e, 1]) - min(
                ref_intervals[r, 0], est_intervals[e, 0]
            )
            overlaps.append((end - start) / span if span > 0 else 0.0)
        avg_overlap = float(np.mean(overlaps))
    else:
        avg_overlap = 0.0
    return {"precision": precision, "recall": recall, "f1": f1,
            "avg_overlap_ratio": avg_overlap}
