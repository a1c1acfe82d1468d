"""Eval boundaries: butted tiles against context-overlapped windows
(counterpart of `tools/eval_boundary.py`).

The eval protocol scores whole recordings reassembled from fixed-size
windows (the reference's `overlap: True` segmentation, config/dataset/
MAPS.yaml:26-44). Frames near a window's edge are denoised with truncated
temporal context, and an onset split across a boundary can fracture a note.
This tool measures what that costs: train the twin of `synthetic_end_to_end`
on v2 clips, build long held-out recordings (several windows each), and
score them two ways with the same trained model and the same sampler draws:

  * tiled    butted windows, concatenated (eval_overlap_frames=0)
  * stitched windows sharing `overlap` frames, crossfade-stitched
             (tasks/transcribe.py::split_windows / stitch_rolls)

    python -m diffroll_tpu_torch.quality.eval_boundary [steps=4000] [n_train=128] \
        [n_long=8] [long_windows=4] [overlap=32] [dtype=bfloat16] [fused_train=1|0] \
        [device=cuda|cpu]

`fused_train` as in `synthetic_end_to_end` (K3 + K4 on the card by
default); `dtype` (bf16 by default, as the JAX tool's) applies to the
modules route. Every batch of windows samples at B=8 (K2 on the card): the
last one is padded with silent windows, as the JAX tool pads it, so both
protocols see the same windows; its x_T and noise come from a generator
seeded 97 + the batch's first window. Prints one JSON line with note and
frame F1 per protocol and the deltas.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

import numpy as np
import torch

from ..cli._common import device_named
from ..data.rasterize import rasterize_notes
from ..eval.evaluate import evaluate_rolls
from ..tasks import DiffusionTask, TaskConfig
from ..tasks.transcribe import split_windows, stitch_rolls
from . import make_synthetic_tree
from .synthetic_end_to_end import (
    BATCH, FRAMES, HOP, SR, TIMESTEPS, build_twin, log, parse_args, render_notes_v2,
    run_training)


def make_notes(seed, n_frames):
    """Note events across a long recording of `n_frames`: deliberately not
    aligned to the window boundaries, so some notes straddle every seam."""
    return make_synthetic_tree.make_notes(seed, n_frames * HOP / SR)


def render(seed: int, rng_seed: int, n_frames: int):
    notes = make_notes(seed, n_frames)
    rng = np.random.RandomState(rng_seed)
    return (render_notes_v2(notes, n_frames * HOP, rng),
            rasterize_notes(notes, n_frames, HOP, SR)[0])


@torch.no_grad()
def transcribe(task: DiffusionTask, audio: np.ndarray, overlap: int, total_frames: int,
               batch: int = BATCH) -> np.ndarray:
    """One recording's roll from its windows, `batch` at a time."""
    mc = task.model.config
    seq, dev = mc.frames * HOP, task.model.device
    wins = split_windows(audio.astype(np.float32), seq, HOP, overlap)
    n = len(wins)
    pad = (-n) % batch
    if pad:
        wins = np.concatenate([wins, np.zeros((pad, seq), np.float32)])
    rolls = []
    for s in range(0, len(wins), batch):
        gen = torch.Generator(device=dev).manual_seed(97 + s)
        x_T = torch.randn((batch, mc.frames, mc.pitches), generator=gen, device=dev)
        chunk = torch.from_numpy(wins[s:s + batch]).to(dev)
        rolls.append(task.sample(x_T, waveform=chunk, generator=gen)[0].cpu().numpy())
    rolls = np.concatenate(rolls)[:n]
    if overlap > 0:
        return stitch_rolls(rolls, overlap, total_frames)
    return np.concatenate(list(rolls))[:total_frames]


def main(argv: Optional[List[str]] = None) -> Dict:
    args = parse_args(argv)
    device = device_named(args.get("device", "cuda"))
    steps = int(args.get("steps", 4000))
    n_train = int(args.get("n_train", 128))
    n_long = int(args.get("n_long", 8))
    long_windows = int(args.get("long_windows", 4))
    overlap = int(args.get("overlap", 32))
    frames = int(args.get("frames", FRAMES))
    fused = bool(int(args.get("fused_train", 1 if device.type == "cuda" else 0)))
    args.setdefault("dtype", "bfloat16")

    log("building corpora...")
    train = [render(i, 10_000 + i, frames) for i in range(n_train)]
    train_audio = torch.from_numpy(np.stack([a for a, _ in train])).to(device)
    train_frame = torch.from_numpy(np.stack([f for _, f in train])).to(device)
    long_frames = frames * long_windows
    longs = [render(5_000 + i, 20_000 + i, long_frames) for i in range(n_long)]

    torch.manual_seed(0)  # the weight init
    model = build_twin(args).to(device)
    timesteps = int(args.get("timesteps", TIMESTEPS))
    task_config = TaskConfig(timesteps=timesteps, training_mode="x_0", loss_type="l2", lr=4e-4,
                             sampling_type="cfdg_ddpm_x0", w=0.5, fused_train=fused)
    run_training(model, task_config, train_frame, train_audio, steps, seed=1, tag="train")
    task = DiffusionTask(model, task_config)

    out = {"train_steps": steps, "overlap_frames": overlap, "long_windows": long_windows,
           "n_long": n_long}
    for tag, ov in (("tiled", 0), ("stitched", overlap)):
        preds = np.stack([transcribe(task, audio, ov, long_frames) for audio, _ in longs])
        m = evaluate_rolls(preds, np.stack([label for _, label in longs]),
                           frame_threshold=0.5, hop_length=HOP, sample_rate=SR)
        out[f"{tag}_note_f1"] = round(m["note_f1"], 4)
        out[f"{tag}_frame_f1"] = round(m["frame_f1"], 4)
        log(f"{tag}: note {m['note_f1']:.4f} frame {m['frame_f1']:.4f}")
    out["note_f1_delta"] = round(out["stitched_note_f1"] - out["tiled_note_f1"], 4)
    out["frame_f1_delta"] = round(out["stitched_frame_f1"] - out["tiled_frame_f1"], 4)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
