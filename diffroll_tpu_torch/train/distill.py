"""Progressive (and guided) distillation training (counterpart of
`diffroll_tpu/train/distill.py`).

Each stage halves the sampler's step count: a student, copied from the
teacher, learns to cover two teacher DDIM steps in one (the math is in
diffusion/distill.py). The first stage can also fold classifier-free
guidance into the student, whose teacher then predicts
(1 + w) cond - w uncond, so every distilled model runs one forward a step.
A distilled checkpoint samples through the ordinary machinery:
`task.sampling_type=ddim_x0 task.sampling_steps=<n> task.w=0`.

Routes on a CUDA model (the JAX package calls `model.apply` for both):
  * the frozen teacher runs under `no_grad` through the gated-stack kernel
    (K1), on operands prepared once per stage from the teacher
    (`TeacherForward`); a guided stage runs both branches as one forward of
    2B rows. `task.use_fused=false` sends it through the `nn.Module`s.
  * the student trains through `DiffusionTask._forward_train`: the
    forward-with-saves and backward kernels (K3 + K4) with
    `task.fused_train=true`, else autograd through the modules.
Every stage's student has its own `torch.optim.Adam(lr)` with fresh moments,
and draws its transitions and noise from a `torch.Generator` on the model's
device, seeded per stage (student_steps * 7919 + 13).

Over the data axis (`mesh`) the student's step is data-parallel: each rank
draws the global batch's transitions and noise and keeps its stripe, the
gradients are averaged (`make_train_step(mesh=)`), and the frozen teacher
is replicated, prepared once per stage on every rank. Under a model axis
the teacher and the student hold their chunks (a student is a deep copy of
its teacher); the teacher's kernel operands are built from its whole
weights, gathered once a stage.
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from ..config.experiment import DistillConfig
from ..data.pipeline import to_device
from ..diffusion.distill import ddim_x0_target, ddim_x0_vec, distill_grids, truncated_snr_weight
from ..diffusion.forward import q_sample
from ..diffusion.samplers import cfg_mix
from ..diffusion.schedule import Schedule
from ..models.base import DiffRollModel
from ..ops.fused_forward import FusedOperands, fused_forward, supports_fused
from ..tasks.diffusion import DiffusionTask, TaskConfig
from .state import TrainState
from .step import make_train_step

__all__ = ["DistillConfig", "TeacherForward", "distill_stage", "make_distill_loss",
           "progressive_distill"]


class TeacherForward:
    """The frozen teacher's x0 prediction `(x, t, cond) -> (B, T, 88)`,
    guidance mixed in where `guided`.

    With `fused` the residual stack runs through `fused_forward` on the
    operands prepared here, once a stage (`FusedOperands`: K1's on a CUDA
    model). They are the teacher's as it is now; a new teacher needs a new
    `TeacherForward`.
    """

    def __init__(self, model: DiffRollModel, guided: bool, w: float, fused: bool):
        self.model, self.guided, self.w, self.fused = model, guided, float(w), fused
        self.operands = FusedOperands.of(model.net) if fused else None

    def _net(self, x, t, cond):
        if not self.fused:
            return self.model.apply(x, t, cond, None)
        return fused_forward(self.model.net, x, t, cond, dilations=self.model.config.dilations(),
                             operands=self.operands)

    @torch.no_grad()
    def __call__(self, x: torch.Tensor, t: torch.Tensor, cond: Optional[torch.Tensor]):
        if not self.guided:
            return self._net(x, t, cond)
        # both branches in one forward of 2B rows: the conditional rows, then
        # the same rows with spec := -1
        b = x.shape[0]
        out = self._net(torch.cat([x, x]), torch.cat([t, t]),
                        torch.cat([cond, torch.full_like(cond, -1.0)]))
        return cfg_mix(out[:b], out[b:], self.w)


def make_distill_loss(
    task: DiffusionTask,
    teacher: DiffRollModel,
    student_grid: np.ndarray,
    midpoints: np.ndarray,
    guided: bool,
    w: float,
    snr_clip: float = 1.0,
    snr_cap: Optional[float] = 5.0,
    conditioner: Optional[Callable[[Dict], torch.Tensor]] = None,
    mesh=None,
):
    """The distillation loss `(batch, generator, train, *, i=None,
    noise=None) -> (loss, (losses, tensors))` of the student `task.model`,
    the same contract as `DiffusionTask.loss_fn` (so `make_train_step` takes
    it). `task.config` routes both forwards (see the module docstring).

    Per example: draw a student transition i (the last one, t = 0 -> done,
    included), form x_t ~ q(x_t | x0), run the teacher two DDIM steps, invert
    the student's one step for its x0 target, and regress with the truncated
    SNR weight. The student takes no spec-dropout mask. `i` (B,) and `noise`
    (B, T, 88) are drawn from `generator` unless given (with `mesh`, the
    global batch's, striped; given ones are this rank's rows). The prepared
    teacher is the returned function's `teacher` attribute.
    """
    model, dev = task.model, task.model.device
    # the tables and grids live on the model's device: a step copies nothing
    # from the host (such a copy from pageable memory waits for the stream)
    schedule = Schedule(*[v.to(dev) for v in task.schedule])
    grid = torch.as_tensor(student_grid, dtype=torch.long, device=dev)
    mids = torch.as_tensor(midpoints, dtype=torch.long, device=dev)
    n = len(student_grid)
    mc = teacher.config
    use_fused = task.config.use_fused
    fused = supports_fused(mc) if use_fused is None else bool(use_fused and supports_fused(mc))
    teacher_predict = TeacherForward(teacher, guided, w, fused)
    if conditioner is None:
        def conditioner(batch):
            return model.conditioner(waveform=batch["audio"])

    def loss_fn(batch, generator: Optional[torch.Generator] = None, train: bool = True, *,
                i: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None):
        del train
        roll = model.normalize_roll(batch["frame"])
        bsz = roll.shape[0]
        cond = conditioner(batch)
        rows = bsz if mesh is None else mesh.global_rows(batch, bsz)
        stripe = (lambda x: x) if mesh is None else mesh.stripe
        if i is None:
            i = stripe(torch.randint(0, n, (rows,), generator=generator, device=dev))
        if noise is None:
            noise = stripe(torch.randn((rows,) + tuple(roll.shape[1:]), generator=generator,
                                       device=dev, dtype=roll.dtype))
        # i == n - 1 is the last transition: t = grid[-1] (0), tm = 0, tp = -1
        t = grid[i]
        last = i >= n - 1
        tm = torch.where(last, 0, mids[i.clamp(max=n - 2)])
        tp = torch.where(last, -1, grid[(i + 1).clamp(max=n - 1)])
        x_t = q_sample(roll, t, schedule, noise)

        with torch.no_grad():
            # the teacher's two DDIM steps t -> tm -> tp; on the last
            # transition x_tm := x_t (t == tm == 0) and the second step alone
            # emits the result
            x0_a = teacher_predict(x_t, t, cond)
            x_tm = ddim_x0_vec(schedule, x_t, t, tm, x0_a)
            x_tm = torch.where(last.reshape((-1,) + (1,) * (roll.ndim - 1)), x_t, x_tm)
            x0_b = teacher_predict(x_tm, tm, cond)
            x_tp = ddim_x0_vec(schedule, x_tm, tm, tp, x0_b)
            target = ddim_x0_target(schedule, x_t, t, tp, x_tp)

        pred = task._forward_train(x_t, t, cond, None)
        wgt = truncated_snr_weight(schedule, t, roll.ndim, snr_clip, snr_cap)
        loss = torch.mean(wgt * (pred - target) ** 2)
        return loss, ({"distill_loss": loss},
                      {"pred_roll": pred, "label_roll": roll, "spec": cond})

    loss_fn.teacher = teacher_predict
    return loss_fn


def distill_stage(
    teacher: DiffRollModel,
    task_config: TaskConfig,
    batches: Iterator[Any],
    student_steps: int,
    n_steps: int,
    lr: float,
    guided: bool = False,
    w: float = 0.0,
    snr_clip: float = 1.0,
    snr_cap: Optional[float] = 5.0,
    log: Optional[Callable[[int, float], None]] = None,
    conditioner: Optional[Callable[[Dict], torch.Tensor]] = None,
    mesh=None,
) -> Tuple[DiffRollModel, float]:
    """One halving: train a student, a deep copy of `teacher`, on the
    `student_steps` grid of `task_config.timesteps`. The teacher is frozen
    (`eval()`, no gradients) and its operands are prepared for this stage.
    Returns (student, the last step's loss)."""
    student_grid, midpoints = distill_grids(task_config.timesteps, student_steps)
    student = copy.deepcopy(teacher).requires_grad_(True)
    teacher.eval().requires_grad_(False)
    task = DiffusionTask(student, task_config)
    loss_fn = make_distill_loss(task, teacher, student_grid, midpoints, guided=guided, w=w,
                                snr_clip=snr_clip, snr_cap=snr_cap, conditioner=conditioner,
                                mesh=mesh)
    state = TrainState.create(student, lr)
    step = make_train_step(loss_fn, mesh)
    dev = student.device
    generator = torch.Generator(device=dev).manual_seed(student_steps * 7919 + 13)
    losses: Dict[str, torch.Tensor] = {}
    for it in range(n_steps):
        losses = step(state, to_device(next(batches), dev), generator)
        if log is not None and (it % 100 == 0 or it == n_steps - 1):
            log(it, float(losses["distill_loss"]))
    # read once after the loop: one device fetch however often it logs
    last = float(losses["distill_loss"]) if losses else float("nan")
    return student.eval(), last


def progressive_distill(
    model: DiffRollModel,
    task_config: TaskConfig,
    batches: Iterator[Any],
    config: DistillConfig = DistillConfig(),
    log: Optional[Callable[[str], None]] = None,
    mesh=None,
) -> Dict[int, DiffRollModel]:
    """The whole halving chain from `model`: {student_steps: student} for
    every stage, each stage's teacher the student before it (guidance is
    folded into the first stage only)."""
    out: Dict[int, DiffRollModel] = {}
    teacher = model
    for stage, n in enumerate(config.stage_steps()):
        guided = config.fold_guidance and stage == 0
        if log is not None:
            log(f"stage {stage}: distilling to {n} steps" + (" (folding CFG)" if guided else ""))
        teacher, _ = distill_stage(
            teacher, task_config, batches, n, n_steps=config.steps_per_stage, lr=config.lr,
            guided=guided, w=config.w, snr_clip=config.snr_clip, snr_cap=config.snr_cap,
            log=(lambda it, v: log(f"  step {it}: distill_loss {v:.6g}"))
            if log is not None else None, mesh=mesh)
        out[n] = teacher
    return out
