"""Batch evaluation: the reference test_step's scoring block as a pure
host-side function (reference task/diffusion.py:381-428; the port's copy of
`diffroll_tpu/eval/evaluate.py`)."""

from __future__ import annotations

from typing import Dict

import numpy as np

from .f1 import frame_metrics, note_metrics
from .notes import extract_notes, notes_to_hz_seconds


def evaluate_rolls(
    pred_rolls: np.ndarray,
    label_rolls: np.ndarray,
    frame_threshold: float = 0.5,
    hop_length: int = 512,
    sample_rate: int = 16000,
    onset_tolerance: float = 0.05,
) -> Dict[str, float]:
    """Score a batch of predicted rolls against labels.

    pred/label: (B, T, 88) activations. Returns frame P/R/F1 (flattened
    over the batch, as the reference does) and note P/R/F1 averaged over
    clips (the reference logs only batch 0's note F1 due to an indentation
    bug, task/diffusion.py:412-427 — we average properly, SURVEY.md §7).
    """
    pred = np.asarray(pred_rolls)
    label = np.asarray(label_rolls)

    fm = frame_metrics(pred, label, frame_threshold)

    note_f1s, note_ps, note_rs = [], [], []
    for i in range(pred.shape[0]):
        p_est, i_est = extract_notes(
            pred[i], pred[i], frame_threshold, frame_threshold, rule="rule1"
        )
        p_ref, i_ref = extract_notes(
            label[i], label[i], frame_threshold, frame_threshold, rule="rule1"
        )
        i_est_s, p_est_hz = notes_to_hz_seconds(p_est, i_est, hop_length, sample_rate)
        i_ref_s, p_ref_hz = notes_to_hz_seconds(p_ref, i_ref, hop_length, sample_rate)
        nm = note_metrics(
            i_ref_s, p_ref_hz, i_est_s, p_est_hz, onset_tolerance=onset_tolerance
        )
        note_ps.append(nm["precision"])
        note_rs.append(nm["recall"])
        note_f1s.append(nm["f1"])

    return {
        "frame_precision": fm["precision"],
        "frame_recall": fm["recall"],
        "frame_f1": fm["f1"],
        "note_precision": float(np.mean(note_ps)) if note_ps else 0.0,
        "note_recall": float(np.mean(note_rs)) if note_rs else 0.0,
        "note_f1": float(np.mean(note_f1s)) if note_f1s else 0.0,
    }
