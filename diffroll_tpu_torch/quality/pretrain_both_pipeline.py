"""The paper's flagship recipe end to end on the synthetic v2 corpus
(counterpart of `tools/pretrain_both_pipeline.sh`):

  1. unconditional pretraining (`train unsupervised_pretrained`, spec
     dropout p = 1) on an unpaired tree of 384 clips (seed 7);
  2. the dual-loss retrain from that checkpoint (`train spec_roll dual=true
     model.spec_dropout=0.1`): conditional on the paired tree plus the
     always-unconditional branch on the unpaired tree, each step a second
     pass through K3 + K4;
  3. a w-sweep of the retrained model (`sweep`, K2);
  4. guided progressive distillation of it (`distill distill.w=0.5`: the
     teacher on K1, the students on K3 + K4), each student scored by `test
     task.sampling_type=ddim_x0 task.sampling_steps=N task.w=0` (K2).

Each stage finds the previous stage's checkpoint as the script does
(`paper_sweeps.stage_checkpoint`: the newest monitored one, else `last`).
The paired tree is the p-sweep's (`paper_sweeps`), so the supervised rows
compare one to one. Every training stage passes `task.fused_train=true`,
and the stages run in this process on the card unless `device=cpu` is
given; `device=cuda` without a card exits.

    python -m diffroll_tpu_torch.quality.pretrain_both_pipeline [smoke] \
        [paired=<tree>] [unpaired=<tree>] [out=<dir>] [device=cuda|cpu]

`smoke` takes the script's tiny sizes (8 x 2 net, 4 steps, 64 frames, one
epoch a stage, a 2-step student); the kernels need 128 channels (64 for the
forward), so on the card give `model.residual_channels=128` with it. Dotted
keys go to every call after the recipe's own. The summary (each stage's
wall seconds, the checkpoints, the sweep rows and the students' metrics)
lands in `<out>/pipeline.json` and as the last stdout line.

The matched-steps supervised control of
`results/pretrain_both_synthetic_v2/supervised_ctrl_6048.json` (6048 steps
on the paired tree, then the same w-sweep) is two commands:

    python -m diffroll_tpu_torch train spec_roll model.spec_dropout=0.1 \
        dataset.root=outputs/psweep_tree model.residual_channels=128 \
        model.residual_layers=8 task.timesteps=100 model.frames=128 \
        dataset.sequence_length=65536 task.lr=4e-4 dataloader.train_batch_size=8 \
        dataloader.test_batch_size=8 dataloader.num_workers=2 task.fused_train=true \
        trainer.max_epochs=252 trainer.output_dir=outputs/pretrain_both/supervised_ctrl
    python -m diffroll_tpu_torch sweep pretrained_path=<its checkpoint> \
        'w_grid=[0.0,0.1,0.5,1.0,1.5,4.0]' 'threshold_grid=[0.5]' \
        dataset.root=outputs/psweep_tree dataset.sequence_length=65536
"""

from __future__ import annotations

import json
import pathlib
import re
import sys
from typing import Dict, List, Optional

from ..cli import _common
from ..cli import distill as distill_cli
from ..cli import sweep as sweep_cli
from ..cli import test as test_cli
from ..cli import train as train_cli
from .paper_sweeps import COMMON, MODEL, W_GRID, dotted, ensure_tree, stage_checkpoint, timed
from .synthetic_end_to_end import parse_args

# tools/pretrain_both_pipeline.sh:20-43
SIZES = {
    "full": dict(paired="outputs/psweep_tree", unpaired="outputs/pretrain_tree",
                 out="outputs/pretrain_both", n1=192, n1t=12, n2=384, n2t=2, model=MODEL,
                 seq2=65536, ep_pre=84, ep_rt=84, val=28, w_grid=W_GRID, dsteps=1000,
                 dstart=17, dstages=3),
    # >= train batch 8 clips: drop_last would starve distill; a 2-step
    # student fits T=4's 3-point grid
    "smoke": dict(paired="outputs/smoke_paired", unpaired="outputs/smoke_unpaired",
                  out="outputs/pretrain_both_smoke", n1=8, n1t=2, n2=8, n2t=2,
                  model=["model.residual_channels=8", "model.residual_layers=2",
                         "task.timesteps=4", "model.frames=64",
                         "dataset.sequence_length=32768"],
                  seq2=32768, ep_pre=1, ep_rt=1, val=1, w_grid="[0.0,0.5]", dsteps=200,
                  dstart=2, dstages=1),
}


def main(argv: Optional[List[str]] = None) -> Dict:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    s = SIZES["smoke" if "smoke" in argv else "full"]
    device = args.get("device", "cuda")
    _common.device_named(device)
    paired = pathlib.Path(args.get("paired", s["paired"]))
    unpaired = pathlib.Path(args.get("unpaired", s["unpaired"]))
    out = pathlib.Path(args.get("out", s["out"]))
    seq2 = args.get("dataset.sequence_length", str(s["seq2"]))
    extra = dotted(args)
    common = [*COMMON, f"device={device}"]
    model = s["model"]
    walls: Dict[str, float] = {}

    timed(walls, "corpora", lambda: (ensure_tree(paired, s["n1"], s["n1t"]),
                                     ensure_tree(unpaired, s["n2"], s["n2t"], seed=7)))
    # dataset.name=MAPS: the unpaired tree is MAPS-layout (the preset's
    # MAESTRO default needs the official metadata for its split)
    timed(walls, "pretrain", train_cli.main, [
        "unsupervised_pretrained", "dataset.name=MAPS", f"dataset.root={unpaired}", *common,
        *model, f"trainer.max_epochs={s['ep_pre']}",
        f"trainer.check_val_every_n_epoch={s['val']}", f"trainer.output_dir={out / 'pretrain'}",
        *extra])
    ckpt_pre = stage_checkpoint(out / "pretrain")
    timed(walls, "retrain_both", train_cli.main, [
        "spec_roll", "dual=true", f"pretrained_path={ckpt_pre}", "model.spec_dropout=0.1",
        f"dataset.root={paired}", "dataset2.name=MAPS", f"dataset2.root={unpaired}",
        f"dataset2.sequence_length={seq2}", *common, *model,
        f"trainer.max_epochs={s['ep_rt']}", f"trainer.check_val_every_n_epoch={s['val']}",
        f"trainer.output_dir={out / 'retrain_both'}", *extra])
    ckpt_both = stage_checkpoint(out / "retrain_both")
    w_rows = timed(walls, "wsweep", sweep_cli.main, [
        f"pretrained_path={ckpt_both}", f"w_grid={s['w_grid']}", "threshold_grid=[0.5]",
        f"dataset.root={paired}", f"dataset.sequence_length={seq2}", *common,
        f"trainer.output_dir={out / 'wsweep'}", *extra])
    distilled = timed(walls, "distill", distill_cli.main, [
        f"pretrained_path={ckpt_both}", f"dataset.root={paired}", *common, *model,
        f"distill.start_steps={s['dstart']}", f"distill.stages={s['dstages']}",
        f"distill.steps_per_stage={s['dsteps']}", "distill.w=0.5",
        f"trainer.output_dir={out / 'distill'}", *extra])

    students = {}
    for d in sorted(pathlib.Path(distilled["run_dir"]).glob("distilled_*steps")):
        n = int(re.fullmatch(r"distilled_(\d+)steps", d.name).group(1))
        students[f"{n}"] = timed(walls, f"distill_eval_{n}", test_cli.main, [
            f"pretrained_path={d / 'checkpoints' / 'last.ckpt'}", "task.sampling_type=ddim_x0",
            f"task.sampling_steps={n}", "task.w=0", f"dataset.root={paired}",
            f"dataset.sequence_length={seq2}", *common,
            f"trainer.output_dir={out / f'distill_eval_{n}'}", *extra])

    summary = {"device": device, "walls_s": walls, "pretrain_ckpt": str(ckpt_pre),
               "retrain_ckpt": str(ckpt_both), "wsweep": w_rows,
               "distill_run": distilled["run_dir"], "students": students}
    out.mkdir(parents=True, exist_ok=True)
    (out / "pipeline.json").write_text(json.dumps(summary, indent=2))
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
