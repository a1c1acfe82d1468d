"""Progressive-distillation entry: compress a trained checkpoint's sampler
(counterpart of `diffroll_tpu/cli/distill.py`).

    python -m diffroll_tpu_torch distill pretrained_path=<file.ckpt> \
        dataset.root=/data distill.stages=4 distill.steps_per_stage=2000 \
        task.fused_train=true

Each stage halves the deterministic sampler's step count (65 -> 33 -> 17 -> 9
-> 5 by default); the first also folds classifier-free guidance (weight
`distill.w`) into the student, so every distilled model runs one forward a
step. On a CUDA model the teacher runs through the gated-stack kernel and,
with `task.fused_train=true`, the student through the training kernels
(train/distill.py).

Each stage is saved as a Lightning-style checkpoint,
`<run dir>/distilled_<n>steps/checkpoints/last.ckpt`, that records its
sampler (`ddim_x0`, n steps, w=0), which `test` and `serve` read:

    python -m diffroll_tpu_torch test \
        pretrained_path=<run dir>/distilled_9steps/checkpoints/last.ckpt \
        task.sampling_type=ddim_x0 task.sampling_steps=9 task.w=0

Under torchrun the student's step is data-parallel over the ranks (each its
stripe of every global batch, the teacher replicated), and rank 0 alone
logs and writes the stage checkpoints. With `trainer.model_axis=M` the
teacher and each student keep their chunks (K1 reads the teacher's whole
weights, gathered once a stage; K3 + K4 the student's, once a step), and
the stage checkpoints are whole.
"""

from __future__ import annotations

import json
import sys
from typing import Any, Dict, List, Optional

from ..config import from_argv
from ..train import Checkpointer, TrainState
from ..train.checkpoint import whole_state
from ..train.distill import progressive_distill
from . import _common


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    cfg, _, overrides = from_argv(sys.argv[1:] if argv is None else argv, "spec_roll")
    mesh, device = _common.setup_mesh(cfg, train=True)
    main_rank = _common.is_main(mesh)
    cfg, model, _, _ = _common.load_pretrained(cfg, prefer_ema=True, overrides=overrides,
                                               device=device)
    _common.shard_model(model, mesh)
    if cfg.task_type != "diffusion":
        raise SystemExit(f"distill needs a diffusion checkpoint; {cfg.pretrained_path} "
                         f"holds a {cfg.task_type!r} model")

    train_ds = _common.build_dataset(cfg.dataset, "train")
    loader = _common.build_loader(cfg, train_ds, "train", mesh)

    def batches():
        while True:
            got = False
            for b in loader:
                got = True
                yield b
            if not got:
                # an empty epoch (fewer items than a batch under the train
                # loader's drop_last) would otherwise spin here for ever
                raise RuntimeError(
                    f"train loader yielded no batches ({len(train_ds)} items, batch_size="
                    f"{cfg.dataloader.train_batch_size}, drop_last) - shrink "
                    "dataloader.train_batch_size or add data")

    run_dir = _common.make_run_dir(cfg, "distill") if main_rank else None
    if main_rank:
        print(f"run dir: {run_dir}", file=sys.stderr)
    students = progressive_distill(
        model, cfg.task, batches(), cfg.distill,
        log=(lambda msg: print(msg, file=sys.stderr)) if main_rank else None, mesh=mesh)
    summary = {"run_dir": str(run_dir), "stages": sorted(students, reverse=True),
               "eval_with": "task.sampling_type=ddim_x0 task.sampling_steps=<n> task.w=0"}
    for n, student in students.items():
        # a distilled model samples unguided (guidance is folded in) on the
        # deterministic grid it was trained for; a sharded student's whole
        # weights are gathered by every rank
        state = TrainState.create(student, cfg.distill.lr)
        whole = whole_state(state)
        if not main_rank:
            continue
        stage_cfg = cfg.replace(task=cfg.task.replace(
            sampling_type="ddim_x0", sampling_steps=n, w=0.0))
        Checkpointer(run_dir / f"distilled_{n}steps" / "checkpoints").save_last(
            state, config=_common.config_record(stage_cfg), whole=whole)
    if not main_rank:
        return summary
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
