"""Transcription of a folder of audio files to piano rolls and MIDI
(counterpart of `diffroll_tpu/cli/transcribe.py`).

    python -m diffroll_tpu_torch transcribe pretrained_path=<file.ckpt> \
        dataset.audio_path=my_audio dataset.audio_ext=wav \
        task.w=0.5 overlap_frames=32 device=cuda

Writes `<name>.npz` (the roll) and `<name>.mid` per file and a
`manifest.json` into outputs/<date>/<time>/transcribe-<run name>.
Architecture and recorded task knobs come from the checkpoint; explicit
`model.*` / `task.*` keys on the command line win. Under torchrun each
file's windows are striped over the ranks, and rank 0 stitches the rolls
and alone writes.
"""

from __future__ import annotations

import json
import pathlib
import sys
from typing import List, Optional

import torch

from ..compat.torch_ckpt import load_lightning
from ..config import from_argv
from ..io.wav import read_wav, resample
from ..tasks.diffusion import DiffusionTask
from ..tasks.transcribe import transcribe_long
from ._common import is_main, make_run_dir, setup_mesh
from .sample import export_clip


def main(argv: Optional[List[str]] = None) -> pathlib.Path:
    argv = sys.argv[1:] if argv is None else argv
    overlap = 32
    rest = []
    for tok in argv:
        if tok.startswith("overlap_frames="):
            overlap = int(tok.split("=", 1)[1])
        else:
            rest.append(tok)
    cfg, positional, overrides = from_argv(rest, "sampling")
    if positional:
        raise SystemExit(f"unexpected arguments: {positional}")
    if not cfg.pretrained_path or pathlib.Path(cfg.pretrained_path).suffix != ".ckpt":
        raise SystemExit("pretrained_path=<file>.ckpt (a Lightning checkpoint) is required")
    mesh, device = setup_mesh(cfg)
    main_rank = is_main(mesh)

    model_over = {k[len("model."):]: v for k, v in overrides.items()
                  if k.startswith("model.")}
    model, task_updates = load_lightning(cfg.pretrained_path, cfg.model_name,
                                         device, model_over)
    # recorded task knobs first, the user's explicit task.* keys win; the
    # schedule length always follows the model's embedding table
    task_updates = {k: v for k, v in task_updates.items() if f"task.{k}" not in overrides}
    task_cfg = cfg.task.replace(**task_updates).replace(timesteps=model.config.timesteps)
    cfg = cfg.replace(model=model.config, task=task_cfg)
    task = DiffusionTask(model, task_cfg, mesh=mesh)
    run_dir = make_run_dir(cfg, "transcribe") if main_rank else None

    folder = pathlib.Path(cfg.dataset.audio_path)
    files = sorted(folder.glob(f"*.{cfg.dataset.audio_ext}"))
    if not files:
        raise SystemExit(f"no *.{cfg.dataset.audio_ext} files under {folder}")

    generator = torch.Generator(device=device).manual_seed(cfg.trainer.seed)
    manifest = []
    for i, f in enumerate(files):
        audio, sr = read_wav(f, mono=True)
        if sr != cfg.dataset.sampling_rate:
            audio = resample(audio, sr, cfg.dataset.sampling_rate)
        roll = transcribe_long(task, audio, generator,
                               sample_rate=cfg.dataset.sampling_rate,
                               batch_size=cfg.dataloader.test_batch_size,
                               overlap_frames=overlap)
        if not main_rank:
            continue
        n_notes = export_clip(run_dir, f"{i:03d}_{f.stem}", roll, cfg)
        manifest.append({"file": f.name, "frames": int(roll.shape[0]), "notes": n_notes})
        print(f"{f.name}: {roll.shape[0]} frames, {n_notes} notes", file=sys.stderr)

    if not main_rank:
        return None
    (run_dir / "manifest.json").write_text(json.dumps(manifest, indent=2))
    print(json.dumps({"run_dir": str(run_dir), "clips": len(manifest)}))
    return run_dir


if __name__ == "__main__":
    main()
