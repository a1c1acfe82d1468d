"""Full-width (512 x 15) progressive distillation and its scoring
(counterpart of `results/fullsize_distill_tpu/run_distill.sh` and
`score_distilled.sh`):

  1. the teacher: the flagship trained on the synthetic v2 tree as
     `results/fullsize_flagship_tpu/` trains it (`train spec_roll
     task.lr=2e-4 trainer.max_epochs=400`, 4800 steps at B=16 through K3 +
     K4);
  2. `distill distill.start_steps=17 distill.stages=3
     distill.steps_per_stage=1000 distill.w=0`: the unguided teacher on K1,
     the students 17 -> 9 -> 5 on K3 + K4;
  3. five operating points, each its own `test` call (K2) on the 12
     held-out clips at B=12, in the scoring script's order: distilled@5,
     the teacher's `ddim_x0`@5 (the equal-compute control), distilled@9,
     the teacher's dense `cfdg_ddpm_x0`@200, distilled@17, all at w=0.

The JAX run's `model.dtype=bfloat16` and packed transfer are not carried
over: the port trains f32 weights through the bf16 kernels. The stages run
in this process on the card unless `device=cpu` is given; `device=cuda`
without a card exits.

    python -m diffroll_tpu_torch.quality.fullsize_distill [tree=outputs/psweep_tree] \
        [out=outputs/fullsize_distill] [device=cuda|cpu]

Dotted keys (`model.residual_channels=16`, `distill.stages=2`) go to every
call after the recipe's own. One row per point (`point`, `sampling_type`,
`sampling_steps` and the `test` metrics) lands in `<out>/scores.json`; the summary, with
each stage's wall seconds, in `<out>/fullsize_distill.json` and as the last
stdout line.
"""

from __future__ import annotations

import json
import pathlib
from typing import Dict, List, Optional

from ..cli import _common
from ..cli import distill as distill_cli
from ..cli import test as test_cli
from ..cli import train as train_cli
from .paper_sweeps import dotted, ensure_tree, stage_checkpoint, timed
from .synthetic_end_to_end import parse_args


def main(argv: Optional[List[str]] = None) -> Dict:
    args = parse_args(argv)
    device = args.get("device", "cuda")
    _common.device_named(device)
    tree = pathlib.Path(args.get("tree", "outputs/psweep_tree"))
    out = pathlib.Path(args.get("out", "outputs/fullsize_distill"))
    extra = dotted(args)
    common = [f"dataset.root={tree}", "dataloader.num_workers=2", f"device={device}"]
    walls: Dict[str, float] = {}

    timed(walls, "tree", ensure_tree, tree)
    timed(walls, "teacher_train", train_cli.main, [
        "spec_roll", *common, "task.lr=2e-4", "task.fused_train=true",
        "trainer.max_epochs=400", "trainer.check_val_every_n_epoch=25",
        f"trainer.output_dir={out / 'teacher'}", *extra])
    teacher = stage_checkpoint(out / "teacher")
    distilled = timed(walls, "distill", distill_cli.main, [
        f"pretrained_path={teacher}", *common, "task.fused_train=true",
        "distill.start_steps=17", "distill.stages=3", "distill.steps_per_stage=1000",
        "distill.w=0",
        f"trainer.output_dir={out / 'distill'}", *extra])
    run = pathlib.Path(distilled["run_dir"])
    steps = sorted(distilled["stages"])  # e.g. [5, 9, 17]

    def student(n: int) -> tuple:
        return (f"distilled@{n}", run / f"distilled_{n}steps" / "checkpoints" / "last.ckpt",
                "ddim_x0", n)

    # score_distilled.sh's order: the cheapest and most telling first
    points = [student(steps[0]), (f"teacher ddim_x0@{steps[0]}", teacher, "ddim_x0", steps[0]),
              *[student(n) for n in steps[1:-1]],
              ("teacher cfdg_ddpm_x0 dense", teacher, "cfdg_ddpm_x0", None),
              *[student(n) for n in steps[1:][-1:]]]
    rows = []
    for name, ckpt, sampler, n_steps in points:
        metrics = timed(walls, f"test {name}", test_cli.main, [
            f"pretrained_path={ckpt}", f"task.sampling_type={sampler}",
            f"task.sampling_steps={'null' if n_steps is None else n_steps}", "task.w=0",
            *common, "dataloader.test_batch_size=12", f"trainer.output_dir={out / 'eval'}",
            *extra])
        rows.append({"point": name, "sampling_type": sampler, "sampling_steps": n_steps,
                     **metrics})

    out.mkdir(parents=True, exist_ok=True)
    (out / "scores.json").write_text(json.dumps(rows, indent=2))
    summary = {"device": device, "walls_s": walls, "teacher": str(teacher),
               "distill_run": str(run), "scores": rows}
    (out / "fullsize_distill.json").write_text(json.dumps(summary, indent=2))
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
