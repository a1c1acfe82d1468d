"""Sampling entry: transcription, inpainting and generation from noise
(counterpart of `diffroll_tpu/cli/sample.py`).

Gaussian noise (S, 640, 88), paired with the waveforms of a folder of audio
(`Custom`) or of a dataset's test split unless the sampler generates from
noise alone, goes through the configured reverse process; every clip is
written as a roll with its trajectory (npz) and as MIDI (notes shorter than
`task.generation_filter` seconds are dropped). MIDI timing uses the real
hop / sample-rate grid.

    python -m diffroll_tpu_torch sample pretrained_path=<file.ckpt> \
        dataset.audio_path=my_audio dataset.audio_ext=wav task.w=0.5
    python -m diffroll_tpu_torch sample pretrained_path=<file.ckpt> \
        task.sampling_type=generation_ddpm_x0 num_samples=8
    python -m diffroll_tpu_torch sample pretrained_path=<file.ckpt> \
        task.sampling_type=inpainting_ddpm_x0 task.inpainting_t=[100,200] dataset.name=MAPS

The trajectory (every 10th step) needs the step loop, so this entry runs
the gated-stack kernel once per step on a card, not the whole-process
sampler. The first clip's denoising GIF is written when matplotlib is
installed; without it stderr says so and the trajectory stays in the npz.
"""

from __future__ import annotations

import json
import sys
from typing import List, Optional

import numpy as np
import torch

from ..config import from_argv
from ..eval.notes import extract_notes
from ..io.midi import write_midi
from . import _common

RECORD_EVERY = 10


def export_clip(run_dir, name, roll, cfg, trajectory=None) -> int:
    """Save one roll as npz (with its trajectory snapshots when given) and
    decoded MIDI; returns the note count. Notes shorter than
    `task.generation_filter` seconds are dropped."""
    np.savez_compressed(run_dir / f"{name}.npz", roll=roll,
                        **({"trajectory": trajectory} if trajectory is not None else {}))
    pitches, intervals = extract_notes(roll, roll, cfg.task.frame_threshold,
                                       cfg.task.frame_threshold)
    scaling = cfg.dataset.hop_length / cfg.dataset.sampling_rate
    keep = (intervals[:, 1] - intervals[:, 0]) * scaling > cfg.task.generation_filter
    pitches, intervals = pitches[keep], intervals[keep]
    sec = intervals.astype(np.float64) * scaling
    write_midi(str(run_dir / f"{name}.mid"), (pitches + 21).tolist(), [tuple(iv) for iv in sec])
    return int(len(pitches))


def _save_gif(trajectory: np.ndarray, path) -> bool:
    """The first clip's denoising animation; False (one stderr line) where
    matplotlib is not installed."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        print("sample: matplotlib is not installed; no denoising.gif (the trajectory is "
              "in the npz)", file=sys.stderr)
        return False
    from ..viz import save_trajectory_gif

    save_trajectory_gif(trajectory, path)
    return True


def main(argv: Optional[List[str]] = None):
    cfg, _, overrides = from_argv(sys.argv[1:] if argv is None else argv, "sampling")
    cfg, model, task, _ = _common.load_pretrained(cfg, overrides=overrides)
    run_dir = _common.make_run_dir(cfg, "sample")
    generation = cfg.task.sampling_type.startswith("generation")
    frames, pitches = cfg.model.frames, cfg.model.pitches
    device = model.device
    generator = torch.Generator(device=device).manual_seed(cfg.trainer.seed)

    if generation:
        # pure noise: no audio
        bs = cfg.dataloader.test_batch_size
        batches = [{"audio": None, "file_name": [f"gen_{i}" for i in range(bs)]}
                   for _ in range(-(-cfg.num_samples // bs))]
    else:
        ds = _common.build_dataset(cfg.dataset, "test")
        batches = _common.build_loader(cfg, ds, "test")

    manifest = []
    idx = 0
    for batch in batches:
        bsz = len(batch["file_name"]) if generation else len(batch["audio"])
        x_T = torch.randn((bsz, frames, pitches), generator=generator, device=device)
        audio = None if batch["audio"] is None else torch.from_numpy(batch["audio"]).to(device)
        x0, traj = task.sample(x_T, waveform=audio, record_every=RECORD_EVERY,
                               generator=generator)
        x0, traj = x0.cpu().numpy(), traj.cpu().numpy()
        if idx == 0:
            _save_gif(traj, run_dir / "denoising.gif")
        names = batch.get("file_name") or [f"clip_{idx + j}" for j in range(bsz)]
        # num_samples caps every mode
        for j in range(min(bsz, cfg.num_samples - idx)):
            name = str(names[j]).rsplit(".", 1)[0]
            n_notes = export_clip(run_dir, f"{idx + j:03d}_{name}", x0[j], cfg,
                                  trajectory=traj[:, j])
            manifest.append({"clip": name, "notes": n_notes})
        idx += bsz
        if idx >= cfg.num_samples:
            break

    (run_dir / "manifest.json").write_text(json.dumps(manifest, indent=2))
    print(json.dumps({"run_dir": str(run_dir), "clips": len(manifest)}))
    return run_dir


if __name__ == "__main__":
    main()
