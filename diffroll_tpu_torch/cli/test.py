"""Evaluation entry: the full reverse process over the test split, then frame
and note P/R/F1 (counterpart of `diffroll_tpu/cli/test.py`).

    python -m diffroll_tpu_torch test pretrained_path=<file.ckpt> \
        dataset.root=/data task.w=0.5 task.frame_threshold=0.5 device=cuda

Every clip is scored (the reference scores only batch 0's notes). An eval
split enumerates consecutive windows covering each recording; the windows
are reassembled into one roll per recording (cross-faded where they
overlap) and scored whole. Writes `test_metrics.json`, and batch 0's rolls,
MIDI and audio, into outputs/<date>/<time>/test-<run name>.

Over the data axis (`torchrun --nproc_per_node=N ... test ...`) each rank
samples its stripe of every test batch, rank 0 gathers the rolls, scores
them and alone writes; every rank returns the same metrics. Under a model
axis (`trainer.model_axis=M`) the ranks of one data index sample the same
stripe, each on the whole weights.
"""

from __future__ import annotations

import json
import sys
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import from_argv
from ..eval.evaluate import evaluate_rolls
from ..tasks.transcribe import stitch_rolls
from . import _common


def _export_batch_artifacts(run_dir, cfg, pred, batch):
    """Batch 0's artifacts, as the reference saves them for every test run:
    predicted and label rolls (npz), decoded MIDI, and the input audio."""
    from ..io.wav import write_audio
    from .sample import export_clip

    run_dir.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(run_dir / "batch0_rolls.npz", pred=pred, label=batch["frame"])
    for j in range(min(2, pred.shape[0])):
        export_clip(run_dir, f"batch0_clip{j}", pred[j], cfg)
        # mp3 where an encoder exists (cfg.audio_format), else 16-bit wav
        write_audio(run_dir / f"batch0_audio{j}", np.asarray(batch["audio"][j]),
                    cfg.dataset.sampling_rate, fmt=cfg.audio_format)


def run_test(cfg, model, task, artifacts_dir=None,
             thresholds=None) -> Dict[str, float]:
    """Full eval over the test split on the model's device. With
    `thresholds` (a list) the same sampled rolls are scored once per
    threshold and {threshold: metrics} is returned: thresholding is
    eval-only, so sampling runs once.

    x_T and every batch's per-step draws come from one `torch.Generator`
    on the model's device, seeded by `trainer.seed`. Over the task's data
    axis (`task.mesh`) every rank loads each whole batch and draws its x_T
    and noise, samples its rows rank::size (`task.sample`), and rank 0
    reassembles and scores
    the gathered rolls; the metrics are rank 0's, broadcast, so n_clips and
    the scores are the single-process run's over the same split.
    """
    test_ds = _common.build_dataset(cfg.dataset, "test")
    loader = _common.build_loader(cfg, test_ds, "test")
    single = thresholds is None
    if single:
        thresholds = [_common.task_threshold(cfg)]
    device = model.device
    mesh = task.mesh
    generator = torch.Generator(device=device).manual_seed(cfg.trainer.seed)

    per_thr: Dict[float, List[Dict[str, float]]] = {t: [] for t in thresholds}
    n_clips = 0
    exported = False
    # per-recording reassembly: windows accumulate per clip_idx and score
    # as one full-recording roll once all of them are in
    pending: Dict[int, Dict] = {}

    def score(pred_roll, label_roll, weight):
        nonlocal n_clips
        for thr in thresholds:
            m = evaluate_rolls(pred_roll, label_roll, frame_threshold=thr,
                               hop_length=cfg.dataset.hop_length,
                               sample_rate=cfg.dataset.sampling_rate)
            m["_n"] = weight
            per_thr[thr].append(m)
        n_clips += weight

    # the dataset clamps the overlap to win_frames - 1 when it places window
    # starts (data/amt.py::n_windows), so the stitch stride shrinks the same
    win_cfg = max(int(cfg.dataset.sequence_length) // int(cfg.dataset.hop_length), 1)
    eval_ov = min(max(int(cfg.dataset.eval_overlap_frames), 0), win_cfg - 1)

    def finalize(ent):
        starts = sorted(ent["pred"])
        n = ent["n_frames"]
        if eval_ov > 0 and len(starts) > 1:
            # overlapped windows: cross-fade the predictions; the labels
            # agree exactly in the overlaps, so overwriting assembles them
            pred_full = stitch_rolls(np.stack([ent["pred"][s] for s in starts]), eval_ov, n)
            first = next(iter(ent["label"].values()))
            label_full = np.zeros((starts[-1] + first.shape[0], 88), first.dtype)
            for s in starts:
                label_full[s: s + first.shape[0]] = ent["label"][s]
        else:
            pred_full = np.concatenate([ent["pred"][s] for s in starts])
            label_full = np.concatenate([ent["label"][s] for s in starts])
        score(pred_full[None, :n], label_full[None, :n], 1)

    batches = 0
    for batch in loader:
        batches += 1
        audio = torch.from_numpy(batch["audio"]).to(device)
        x_T = torch.randn(batch["frame"].shape, generator=generator, device=device)
        pred = task.sample(x_T, waveform=audio, generator=generator)[0]
        if pred is None:  # not rank 0 of the data axis: the rolls went there
            continue
        pred = pred.cpu().numpy()
        if artifacts_dir is not None and not exported:
            _export_batch_artifacts(artifacts_dir, cfg, pred, batch)
            exported = True
        if "clip_idx" in batch:
            win_frames = pred.shape[1]
            for j in range(pred.shape[0]):
                ent = pending.setdefault(int(batch["clip_idx"][j]), {
                    "pred": {}, "label": {}, "n_frames": int(batch["n_clip_frames"][j])})
                sf = int(batch["start_frame"][j])
                ent["pred"][sf] = pred[j]
                ent["label"][sf] = batch["frame"][j]
            for ci in sorted(pending):
                ent = pending[ci]
                if hasattr(test_ds, "n_windows"):
                    expected = test_ds.n_windows(ent["n_frames"])
                else:
                    expected = max(1, -(-ent["n_frames"] // win_frames))
                if len(ent["pred"]) >= expected:
                    finalize(pending.pop(ci))
        else:
            score(pred, batch["frame"], int(pred.shape[0]))

    if batches == 0:
        raise FileNotFoundError("test split resolved to zero batches")
    if mesh is not None and not mesh.is_main:
        return mesh.broadcast_object(None)

    for ci in sorted(pending):  # a recording whose windows never completed
        finalize(pending.pop(ci))

    def reduce(all_metrics):
        weights = np.array([m.pop("_n") for m in all_metrics], np.float64)
        weights /= weights.sum()
        out = {k: float(np.sum([m[k] * w for m, w in zip(all_metrics, weights)]))
               for k in all_metrics[0]}
        out["n_clips"] = n_clips
        # the window-stitch geometry that produced these numbers
        out["eval_overlap_frames"] = eval_ov
        return out

    results = {t: reduce(ms) for t, ms in per_thr.items()}
    out = results[thresholds[0]] if single else results
    return out if mesh is None else mesh.broadcast_object(out)


def main(argv: Optional[List[str]] = None) -> Dict[str, float]:
    cfg, _, overrides = from_argv(sys.argv[1:] if argv is None else argv, "test")
    mesh, device = _common.setup_mesh(cfg)
    cfg, model, task, _ = _common.load_pretrained(cfg, overrides=overrides, device=device,
                                                  mesh=mesh)

    # this entry keeps the test preset's sampler, but says so when a
    # checkpoint the port trained recorded another one (w may differ:
    # only the sampler's identity and grid are compared)
    stored_task = _common.stored_task_config(cfg.pretrained_path)
    if stored_task is not None and cfg.task_type != "baseline" and _common.is_main(mesh):
        eff = (cfg.task.sampling_type, cfg.task.sampling_steps)
        rec = (stored_task.sampling_type, stored_task.sampling_steps)
        pinned = {"task.sampling_type", "task.sampling_steps"} & set(overrides)
        if eff != rec and not pinned:
            print(f"note: evaluating with sampler {eff}; the checkpoint recorded {rec} "
                  f"(a distilled student must run its own grid) - pass "
                  f"task.sampling_type= / task.sampling_steps= to change", file=sys.stderr)

    run_dir = _common.make_run_dir(cfg, "test") if _common.is_main(mesh) else None
    metrics = run_test(cfg, model, task, artifacts_dir=run_dir)
    if run_dir is not None:
        (run_dir / "test_metrics.json").write_text(json.dumps(metrics, indent=2))
        print(json.dumps(metrics))
    return metrics


if __name__ == "__main__":
    main()
