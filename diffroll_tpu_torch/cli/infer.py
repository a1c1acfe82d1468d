"""Unconditional roll generation with the U-Net family (counterpart of
`diffroll_tpu/cli/infer.py`): pure noise shaped like a piano roll goes
through the unconditional reverse process; each roll is saved with its
trajectory (every 10th step) as npz, and as MIDI.

    python -m diffroll_tpu_torch infer pretrained_path=<file.ckpt> num_samples=4

x_T (num_samples, frames, 88) and the per-step noise come from one
`torch.Generator` on the model's device, seeded by `trainer.seed`. Writes
`roll_<j>.npz`, `roll_<j>.mid` and `manifest.json` into
outputs/<date>/<time>/infer-<run name>, and prints {"run_dir", "clips"}.
"""

from __future__ import annotations

import json
import sys
from typing import List, Optional

import torch

from ..config import from_argv
from . import _common
from .sample import RECORD_EVERY, export_clip


def main(argv: Optional[List[str]] = None):
    cfg, _, overrides = from_argv(sys.argv[1:] if argv is None else argv, "infer")
    cfg, model, task, _ = _common.load_pretrained(cfg, overrides=overrides)
    run_dir = _common.make_run_dir(cfg, "infer")
    device = model.device
    generator = torch.Generator(device=device).manual_seed(cfg.trainer.seed)
    x_T = torch.randn((cfg.num_samples, cfg.model.frames, cfg.model.pitches),
                      generator=generator, device=device)
    x0, traj = task.sample(x_T, record_every=RECORD_EVERY, generator=generator)
    x0, traj = x0.cpu().numpy(), traj.cpu().numpy()

    manifest = []
    for j in range(cfg.num_samples):
        n = export_clip(run_dir, f"roll_{j:03d}", x0[j], cfg, trajectory=traj[:, j])
        manifest.append({"clip": f"roll_{j:03d}", "notes": n})
    (run_dir / "manifest.json").write_text(json.dumps(manifest, indent=2))
    print(json.dumps({"run_dir": str(run_dir), "clips": len(manifest)}))
    return run_dir


if __name__ == "__main__":
    main()
