"""The paper's central experiment on the synthetic v2 tree: F1 against spec
dropout p, F1 against guidance w, and inpainting on the p = 0.1 model
(the recipes of `results/psweep_synthetic_v2/README.md`,
`results/wsweep_synthetic_v2/README.md` and
`results/inpainting_synthetic_v2/README.md`, through the port's entries).

  1. the tree: `make_synthetic_tree n_train=192 n_test=12 seconds=20.48`
     (skipped when `tree=` already holds one);
  2. the p-sweep: `sweep spec_roll p_grid=[0,0.1,0.2,0.3,0.4,0.5,0.65]`, one
     `train` run per p at 128 x 8, T=100, 128 frames, lr 4e-4, B=8, 84 epochs
     (2016 steps), each scored on the 12 held-out clips at w=0;
  3. the w-sweeps: `sweep pretrained_path=<p ckpt> w_grid=[0,0.1,0.5,1,1.5,4]
     threshold_grid=[0.5]` for p = 0, 0.1 and 0.5;
  4. `eval_inpainting mask=48,80` and `fmask=29,51` on the p = 0.1 model.

Every training run passes `task.fused_train=true` (K3 + K4 on the card), and
every score samples through K2. The stages run in this process, on the card
unless `device=cpu` is given; `device=cuda` without a card exits.

    python -m diffroll_tpu_torch.quality.paper_sweeps [tree=outputs/psweep_tree] \
        [out=outputs/paper_sweeps] [device=cuda|cpu]

`p_grid=` and `w_grid=` change the grids (`p_grid` must hold the w-swept
p = 0, 0.1 and 0.5); dotted keys (`trainer.max_epochs=1`) go to every
`train` and `sweep` call after the recipe's own. The summary, with each
stage's wall seconds and, under `stage_checkpoints`, each checkpoint a later
stage started from with its `global_step` (the p-sweep's scores are the
post-fit test's, on each run's final weights), lands in
`<out>/paper_sweeps.json` and as the last stdout line.
"""

from __future__ import annotations

import json
import pathlib
import time
from typing import Callable, Dict, List, Optional

from ..cli import _common
from ..cli import sweep as sweep_cli
from ..compat import peek_global_step
from ..train import Checkpointer
from . import eval_inpainting, make_synthetic_tree
from .synthetic_end_to_end import log, parse_args

# results/psweep_synthetic_v2/README.md: the twin's geometry, lr and batches
MODEL = ["model.residual_channels=128", "model.residual_layers=8", "task.timesteps=100",
         "model.frames=128", "dataset.sequence_length=65536"]
COMMON = ["task.lr=4e-4", "dataloader.train_batch_size=8", "dataloader.test_batch_size=8",
          "dataloader.num_workers=2", "task.fused_train=true"]
P_GRID = "[0.0,0.1,0.2,0.3,0.4,0.5,0.65]"
W_GRID = "[0.0,0.1,0.5,1.0,1.5,4.0]"
W_ROWS = (0.0, 0.1, 0.5)  # results/wsweep_synthetic_v2/README.md: the p values w-swept
BANDS = (("mask", "48,80"), ("fmask", "29,51"))  # results/inpainting_synthetic_v2


def dotted(args: Dict[str, str]) -> List[str]:
    """The `key.sub=value` tokens of `args`, for the CLI calls."""
    return [f"{k}={v}" for k, v in args.items() if "." in k]


def stage_checkpoint(out_dir: pathlib.Path) -> pathlib.Path:
    """The checkpoint a later stage starts from, found as the JAX scripts find
    it (`find <out> -type d -name checkpoints | sort | tail -1`): the newest
    run's `checkpoints` directory, and in it the newest monitored (best)
    checkpoint, else `last`."""
    dirs = sorted(p for p in pathlib.Path(out_dir).rglob("checkpoints") if p.is_dir())
    if not dirs:
        raise FileNotFoundError(f"no checkpoints directory under {out_dir}")
    return Checkpointer(dirs[-1]).resolve()


def timed(walls: Dict[str, float], name: str, fn: Callable, *args):
    """Run one stage, keeping its wall seconds under `name`."""
    log(f"=== {name} ===")
    t0 = time.perf_counter()
    out = fn(*args)
    walls[name] = time.perf_counter() - t0
    log(f"=== {name}: {walls[name]:.1f} s ===")
    return out


def ensure_tree(root: pathlib.Path, n_train: int = 192, n_test: int = 12,
                seed: int = 0) -> None:
    """A MAPS-layout tree of 20.48 s v2 recordings at `root`, unless one is
    there (by default the p-sweep's: 192 + 12)."""
    if not (root / "MAPS").is_dir():
        make_synthetic_tree.write_tree(root, n_train=n_train, n_test=n_test, seconds=20.48,
                                       seed=seed)


def p_sweep_argv(tree: pathlib.Path, out: pathlib.Path, p_grid: str, device: str,
                 extra: List[str]) -> List[str]:
    """The p-sweep's `sweep` call: one `train` run of the recipe (84 epochs of
    24 steps, validated every 21) per p of `p_grid`, under `<out>/p_sweep/`."""
    return ["spec_roll", f"p_grid={p_grid}", f"dataset.root={tree}", *MODEL, *COMMON,
            "trainer.max_epochs=84", "trainer.check_val_every_n_epoch=21",
            f"trainer.output_dir={out}", device, *extra]


def main(argv: Optional[List[str]] = None) -> Dict:
    args = parse_args(argv)
    device = args.get("device", "cuda")
    _common.device_named(device)
    tree = pathlib.Path(args.get("tree", "outputs/psweep_tree"))
    out = pathlib.Path(args.get("out", "outputs/paper_sweeps"))
    extra = dotted(args)
    dev = f"device={device}"
    seq = args.get("dataset.sequence_length", "65536")
    walls: Dict[str, float] = {}

    timed(walls, "tree", ensure_tree, tree)
    p_rows = timed(walls, "p_sweep", sweep_cli.main,
                   p_sweep_argv(tree, out / "psweep", args.get("p_grid", P_GRID), dev, extra))

    stage_ckpts: Dict[str, Dict] = {}

    def ckpt(p: float) -> pathlib.Path:
        path = stage_checkpoint(out / "psweep" / "p_sweep" / f"p{p:g}")
        stage_ckpts[f"p{p:g}"] = {"file": str(path), "global_step": peek_global_step(str(path))}
        return path

    w_rows = {}
    for p in W_ROWS:
        w_rows[f"{p:g}"] = timed(walls, f"w_sweep_p{p:g}", sweep_cli.main, [
            f"pretrained_path={ckpt(p)}", f"w_grid={args.get('w_grid', W_GRID)}",
            "threshold_grid=[0.5]", f"dataset.root={tree}", f"dataset.sequence_length={seq}",
            "dataloader.test_batch_size=8", "dataloader.num_workers=2",
            f"trainer.output_dir={out / f'wsweep_p{p:g}'}", dev, *extra])

    inpainting = {}
    model_keys = [t for t in extra if t.startswith("model.")]
    for band, spec in BANDS:
        inpainting[f"{band}={spec}"] = timed(walls, f"inpainting_{band}", eval_inpainting.main, [
            f"ckpt={ckpt(0.1)}", f"root={tree}", f"{band}={spec}", "w=0.5", f"seq={seq}",
            f"tmpdir={out / 'inpainting'}", dev, *model_keys])

    summary = {"device": device, "tree": str(tree), "walls_s": walls, "p_sweep": p_rows,
               "stage_checkpoints": stage_ckpts, "w_rows": w_rows, "inpainting": inpainting}
    out.mkdir(parents=True, exist_ok=True)
    (out / "paper_sweeps.json").write_text(json.dumps(summary, indent=2))
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
