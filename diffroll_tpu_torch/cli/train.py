"""Training entry: the supervised, unsupervised-pretrain, baseline and
fine-tuning recipes (counterpart of `diffroll_tpu/cli/train.py`).

    python -m diffroll_tpu_torch train spec_roll dataset.root=/data model.kernel_size=9
    python -m diffroll_tpu_torch train unsupervised_pretrained dataset.root=/data
    python -m diffroll_tpu_torch train baseline dataset.root=/data   # the one-shot
                                        # regression, through the nn.Modules
    python -m diffroll_tpu_torch train spec_roll pretrained_path=out/last.ckpt \
        model.spec_dropout=0.5                      # continue on one dataset
    python -m diffroll_tpu_torch train spec_roll pretrained_path=out/last.ckpt \
        dual=true dataset2.name=MAESTRO             # the dual-loss recipe

`task.fused_train=true` runs the residual stack through the training kernels
on a CUDA device, for the model families they cover (the 1-D stack with
fixed or no conditioning); the others train through their `nn.Module`s.
Every model preset trains here, the U-Nets too (`train pianoroll`, or
`model_name=SpecUnet`). Each validation writes the first batch's one-step
prediction as `figures/val_rolls_<step>.png`, and for trainable
conditioning `figures/val_trainable_params_<step>.png`; without matplotlib,
one stderr line says so. After `fit` the test split is evaluated as `test` would
evaluate the checkpoint (on the EMA weights when `trainer.ema_decay` is set)
and `test_metrics.json` is written; a layout without a test split skips it
with one stderr line.

`model.dtype=bfloat16` computes the 1-D net's convs in bf16 on f32 weights,
and `trainer.adam_moments_dtype=bfloat16` stores Adam's moments in bf16
(a fresh optimizer when starting from `pretrained_path`). Over the data
axis, one process per GPU:

    torchrun --nproc_per_node=4 -m diffroll_tpu_torch train spec_roll \
        dataset.root=/data trainer.data_axis=4

each rank steps on its stripe of every global batch of
`dataloader.train_batch_size` with the gradients averaged, and only rank 0
writes the logs, figures, checkpoints and the test metrics. With
`trainer.model_axis=M` (N / M data stripes) each rank keeps its chunk of
every parameter whose output channels divide by M, with its Adam moments
and EMA; the products are column-parallel, K3 + K4 take the whole weights
gathered once a step, and the checkpoints are whole:

    torchrun --nproc_per_node=4 -m diffroll_tpu_torch train spec_roll \
        dataset.root=/data trainer.model_axis=2 task.fused_train=true
"""

from __future__ import annotations

import json
import sys
from typing import List, Optional

import torch

from ..config import asdict_flat, from_argv
from ..data.custom import DoubleDataset
from ..parallel.model_axis import full_tensors, full_view, is_sharded
from ..train import Checkpointer, TrainState, fit
from ..utils.logging import MetricLogger
from . import _common
from .test import run_test


def make_val_hook(task, logger: Optional[MetricLogger]):
    """`fit`'s hook on the first validation batch: the one-step prediction
    beside the labels and the conditioner (`roll_figure`), and the heatmaps
    of the learned conditioning where the net has any (`param_heatmaps`),
    saved as PNGs. Its draws come from a generator of its own (seed 0). A
    model-sharded net reads whole inside (`full_view`), which every rank
    enters; a rank without `logger` draws no figure."""
    warned = False

    def val_hook(state, batch):
        nonlocal warned
        try:
            import matplotlib  # noqa: F401
        except ImportError:
            if not warned and logger is not None:
                print("train: matplotlib is not installed; no validation figures",
                      file=sys.stderr)
            warned = True
            return {}
        from ..viz import param_heatmaps, roll_figure
        from ..viz.figures import _mpl

        gen = torch.Generator(device=state.model.device).manual_seed(0)
        with torch.no_grad(), full_view(state.model.net) as net:
            if logger is None:
                return {}
            _, (_, tensors) = task.loss_fn(batch, gen, False)
            spec = tensors.get("spec")
            figs = {"val/rolls": roll_figure(tensors["pred_roll"].cpu().numpy(),
                                             tensors["label_roll"].cpu().numpy(),
                                             None if spec is None else spec.cpu().numpy()),
                    "val/trainable_params": param_heatmaps(net)}
        for tag, fig in figs.items():
            if fig is not None:
                logger.log_figure(state.step, tag, fig)
                _mpl().close(fig)
        return {}

    return val_hook


def main(argv: Optional[List[str]] = None) -> TrainState:
    cfg, rest, overrides = from_argv(sys.argv[1:] if argv is None else argv, "spec_roll")
    dual = cfg.dual or "dual" in rest or cfg.dataset2 is not None
    mesh, device = _common.setup_mesh(cfg, train=True)
    main_rank = _common.is_main(mesh)

    if cfg.pretrained_path:
        cfg, model, task, state = _common.load_pretrained(cfg, prefer_ema=False,
                                                           overrides=overrides, device=device,
                                                           mesh=mesh)
    else:
        torch.manual_seed(cfg.trainer.seed)  # the weight init
        model, task = _common.setup_model_task(cfg, device, mesh)
        state = _common.new_train_state(cfg, model)
    _common.shard_model(model, mesh, state.optimizer)

    if dual and cfg.dataset2 is None:
        # the reference's defaults: MAPS + MAESTRO
        cfg = cfg.replace(dataset2=cfg.dataset.replace(name="MAESTRO"))
    if dual:
        cfg = cfg.replace(task=cfg.task.replace(
            loss_keys=("diffusion_loss", "unconditional_diffusion_loss")))
        task = task.__class__(model, cfg.task, mesh=mesh)

    train_ds = _common.build_dataset(cfg.dataset, "train")
    if dual:
        train_ds = DoubleDataset(train_ds, _common.build_dataset(cfg.dataset2, "train"))
    try:
        val_ds = _common.build_dataset(cfg.dataset, "validation")
        val_loader = _common.build_loader(cfg, val_ds, "validation", mesh)
    except FileNotFoundError:
        val_loader = None  # no validation split in this layout
    train_loader = _common.build_loader(cfg, train_ds, "train", mesh)

    # rank 0 alone writes: the others keep no logger, checkpointer or hook
    logger = ckpt = run_dir = None
    if main_rank:
        run_dir = _common.make_run_dir(cfg, "train")
        logger = MetricLogger(run_dir)
        logger.log_config(asdict_flat(cfg))
        ckpt = Checkpointer(run_dir / "checkpoints", max_to_keep=cfg.trainer.save_top_k)
        print(f"run dir: {run_dir}", file=sys.stderr)
    sharded = is_sharded(model.net)
    state = fit(task, state, train_loader, trainer=cfg.trainer, val_loader=val_loader,
                checkpointer=ckpt, logger=logger, config_record=_common.config_record(cfg),
                val_hook=make_val_hook(task, logger) if main_rank or sharded else None,
                mesh=mesh)

    # the test split, on what `test pretrained_path=<last.ckpt>` loads: the
    # EMA weights when the run kept them (the returned state keeps the raw
    # ones), whole on every rank (a sharded net's gathered)
    eval_model, eval_task = model, task
    if state.ema is not None or sharded:
        weights = state.ema if state.ema is not None else {
            n: p.detach() for n, p in model.net.named_parameters()}
        eval_model, eval_task = _common.setup_model_task(cfg, device, mesh)
        eval_model.net.load_state_dict(full_tensors(model.net, weights))
    try:
        metrics = run_test(cfg, eval_model, eval_task)
        if main_rank:
            (run_dir / "test_metrics.json").write_text(json.dumps(metrics, indent=2))
            print(json.dumps(metrics))
    except FileNotFoundError as e:
        if main_rank:
            print(f"skipping test split: {e}", file=sys.stderr)
    if main_rank:
        logger.close()
        print(json.dumps({"run_dir": str(run_dir), "steps": state.step,
                          "last": str(ckpt.resolve("last"))}))
    return state


if __name__ == "__main__":
    main()
