"""The port's frame / note F1 and batch scoring (`eval/f1.py`,
`eval/evaluate.py`) against the JAX package's on seeded random rolls and
note lists, empty and full rolls included. Both sides are numpy, so they
agree to 1e-12."""

import numpy as np
import pytest

from diffroll_tpu.eval import evaluate as jevaluate
from diffroll_tpu.eval import f1 as jf1
from diffroll_tpu_torch import eval as teval
from diffroll_tpu_torch.eval import evaluate as tevaluate
from diffroll_tpu_torch.eval import f1 as tf1
from torch_native_tiers import native_tiers_pinned  # noqa: F401

EXACT = 1e-12


def _assert_same(t, j):
    assert t.keys() == j.keys()
    for k in j:
        assert abs(t[k] - j[k]) <= EXACT, (k, t[k], j[k])


def _rolls(seed, b=2, frames=64, density=0.1):
    """Seeded activations and binary labels made of short notes."""
    rng = np.random.default_rng(seed)
    label = np.zeros((b, frames, 88), np.float32)
    for i in range(b):
        for _ in range(int(density * 88)):
            p, on = int(rng.integers(0, 88)), int(rng.integers(0, frames - 4))
            label[i, on: on + int(rng.integers(2, 12)), p] = 1.0
    pred = np.clip(label * rng.uniform(0.3, 1.0, label.shape)
                   + 0.4 * rng.random(label.shape), 0.0, 1.0).astype(np.float32)
    return pred, label


def _notes(rng, n, jitter=0.0):
    onsets = np.sort(rng.uniform(0.0, 10.0, n))
    intervals = np.stack([onsets, onsets + rng.uniform(0.05, 1.0, n)], axis=1)
    pitches = 440.0 * 2.0 ** ((rng.integers(21, 109, n) - 69) / 12.0)
    if jitter:
        intervals = intervals + rng.uniform(-jitter, jitter, intervals.shape)
    return intervals, pitches


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("threshold", [0.3, 0.5, 0.9])
def test_frame_metrics_match_jax(seed, threshold):
    pred, label = _rolls(seed)
    _assert_same(tf1.frame_metrics(pred, label, threshold),
                 jf1.frame_metrics(pred, label, threshold))


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("offset_ratio", [None, 0.2])
def test_note_matching_matches_jax(seed, offset_ratio):
    rng = np.random.default_rng(seed)
    ref_iv, ref_hz = _notes(rng, 30)
    # estimates: most references moved by up to 80 ms, plus spurious notes
    keep = rng.random(30) < 0.8
    est_iv = np.concatenate([ref_iv[keep] + rng.uniform(-0.08, 0.08, (keep.sum(), 2)),
                             _notes(rng, 8)[0]])
    est_hz = np.concatenate([ref_hz[keep] * 2.0 ** (rng.uniform(-0.6, 0.6, keep.sum()) / 12),
                             _notes(rng, 8)[1]])
    tm = tf1.match_notes(ref_iv, ref_hz, est_iv, est_hz, offset_ratio=offset_ratio)
    jm = jf1.match_notes(ref_iv, ref_hz, est_iv, est_hz, offset_ratio=offset_ratio)
    assert tm == jm and len(tm) > 0
    _assert_same(tf1.note_metrics(ref_iv, ref_hz, est_iv, est_hz, offset_ratio=offset_ratio),
                 jf1.note_metrics(ref_iv, ref_hz, est_iv, est_hz, offset_ratio=offset_ratio))


@pytest.mark.parametrize("n_ref,n_est", [(0, 0), (0, 5), (5, 0)])
def test_note_metrics_on_empty_lists_match_jax(n_ref, n_est):
    rng = np.random.default_rng(0)
    ref_iv, ref_hz = _notes(rng, n_ref)
    est_iv, est_hz = _notes(rng, n_est)
    assert tf1.match_notes(ref_iv, ref_hz, est_iv, est_hz) == []
    _assert_same(tf1.note_metrics(ref_iv, ref_hz, est_iv, est_hz),
                 jf1.note_metrics(ref_iv, ref_hz, est_iv, est_hz))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("threshold", [0.3, 0.5])
def test_evaluate_rolls_matches_jax(seed, threshold):
    pred, label = _rolls(seed, b=3, frames=96)
    got = tevaluate.evaluate_rolls(pred, label, frame_threshold=threshold)
    want = jevaluate.evaluate_rolls(pred, label, frame_threshold=threshold)
    _assert_same(got, want)
    assert 0.0 < got["note_f1"] <= 1.0 and 0.0 < got["frame_f1"] <= 1.0


@pytest.mark.parametrize("kind", ["empty", "full", "empty_pred", "full_pred"])
def test_evaluate_rolls_on_empty_and_full_rolls_match_jax(kind):
    _, label = _rolls(7)
    pred = {"empty": np.zeros_like(label), "full": np.ones_like(label),
            "empty_pred": np.zeros_like(label), "full_pred": np.ones_like(label)}[kind]
    if kind in ("empty", "full"):
        label = pred.copy()
    _assert_same(tevaluate.evaluate_rolls(pred, label, hop_length=512, sample_rate=16000),
                 jevaluate.evaluate_rolls(pred, label, hop_length=512, sample_rate=16000))


def test_package_exports():
    assert teval.evaluate_rolls is tevaluate.evaluate_rolls
    assert {"frame_metrics", "match_notes", "note_metrics", "extract_notes"} <= set(teval.__all__)
