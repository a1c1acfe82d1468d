"""Training entry: the supervised, unsupervised-pretrain and fine-tuning
recipes (counterpart of `diffroll_tpu/cli/train.py`).

    python -m diffroll_tpu_torch train spec_roll dataset.root=/data model.kernel_size=9
    python -m diffroll_tpu_torch train unsupervised_pretrained dataset.root=/data
    python -m diffroll_tpu_torch train spec_roll pretrained_path=out/last.ckpt \
        model.spec_dropout=0.5                      # continue on one dataset
    python -m diffroll_tpu_torch train spec_roll pretrained_path=out/last.ckpt \
        dual=true dataset2.name=MAESTRO             # the dual-loss recipe

`task.fused_train=true` runs the residual stack through the training kernels
on a CUDA device. The JAX package goes on to evaluate the test split after
`fit`; that needs the `test` entry, which is not ported yet, so this entry
ends after `fit` and says so on stderr.
"""

from __future__ import annotations

import json
import sys
from typing import List, Optional

import torch

from ..config import asdict_flat, from_argv
from ..data.custom import DoubleDataset
from ..train import Checkpointer, TrainState, fit
from ..utils.logging import MetricLogger
from . import _common


def main(argv: Optional[List[str]] = None) -> TrainState:
    cfg, rest, overrides = from_argv(sys.argv[1:] if argv is None else argv, "spec_roll")
    dual = cfg.dual or "dual" in rest or cfg.dataset2 is not None
    device = _common.resolve_device(cfg)

    if cfg.pretrained_path:
        cfg, model, task, state = _common.load_pretrained(cfg, prefer_ema=False,
                                                           overrides=overrides)
    else:
        torch.manual_seed(cfg.trainer.seed)  # the weight init
        model, task = _common.setup_model_task(cfg, device)
        state = TrainState.create(model, _common.task_lr(cfg))

    if dual and cfg.dataset2 is None:
        # the reference's defaults: MAPS + MAESTRO
        cfg = cfg.replace(dataset2=cfg.dataset.replace(name="MAESTRO"))
    if dual:
        cfg = cfg.replace(task=cfg.task.replace(
            loss_keys=("diffusion_loss", "unconditional_diffusion_loss")))
        task = task.__class__(model, cfg.task)

    train_ds = _common.build_dataset(cfg.dataset, "train")
    if dual:
        train_ds = DoubleDataset(train_ds, _common.build_dataset(cfg.dataset2, "train"))
    try:
        val_ds = _common.build_dataset(cfg.dataset, "validation")
        val_loader = _common.build_loader(cfg, val_ds, "validation")
    except FileNotFoundError:
        val_loader = None  # no validation split in this layout
    train_loader = _common.build_loader(cfg, train_ds, "train")

    run_dir = _common.make_run_dir(cfg, "train")
    logger = MetricLogger(run_dir)
    logger.log_config(asdict_flat(cfg))
    ckpt = Checkpointer(run_dir / "checkpoints", max_to_keep=cfg.trainer.save_top_k)

    print(f"run dir: {run_dir}", file=sys.stderr)
    state = fit(task, state, train_loader, trainer=cfg.trainer, val_loader=val_loader,
                checkpointer=ckpt, logger=logger,
                config_record=_common.config_record(cfg))
    logger.close()
    print("train: the test-split evaluation after fit is not ported yet; stopping after fit",
          file=sys.stderr)
    print(json.dumps({"run_dir": str(run_dir), "steps": state.step,
                      "last": str(ckpt.resolve("last"))}))
    return state


if __name__ == "__main__":
    main()
