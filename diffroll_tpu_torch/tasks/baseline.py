"""The discriminative (one-shot) baseline task (counterpart of
`diffroll_tpu/tasks/baseline.py`): a spec -> roll regression dressed in
diffusion clothing. The network gets a dummy x_t and a dummy timestep and
predicts the roll from the spectrogram alone; `amt_loss` is the MSE against
the unnormalised roll.

Kept from the reference:
  * time_mode 'constant' (t = 1), 'constant_maxT' (t = T - 1) or 'random'
    (t ~ U[0, 100));
  * x_t 'zeros' or 'gaussian', where 'gaussian' draws UNIFORM noise (the
    reference's `torch.rand_like`), since training and evaluation must agree
    on the dummy input's distribution;
  * one forward per step of the evaluation walk (the reference runs it twice).

The JAX task only ever calls `model.apply`, so this one runs
`DiffRollBaseline` (kernel 7, dilation 1) through the `nn.Module`s, on the
model's device, and launches no kernel: none of the four kernels covers a
one-shot regression, and the stack kernel's operands are never prepared here.
Over the data axis (`mesh`) the dummy inputs and the walk's noise are the
global batch's, striped, as in tasks/diffusion.py.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from ..diffusion.loop import sample_loop
from ..diffusion.samplers import ddpm_x0_step
from ..diffusion.schedule import linear_schedule
from ..models.base import DiffRollModel


@dataclasses.dataclass(frozen=True)
class BaselineConfig:
    """Same fields and defaults as `diffroll_tpu.tasks.baseline.BaselineConfig`."""

    timesteps: int = 200
    beta_start: float = 1e-4
    beta_end: float = 0.02
    loss_keys: Tuple[str, ...] = ("amt_loss",)
    frame_threshold: float = 0.6
    time_mode: str = "constant_maxT"   # 'constant' | 'constant_maxT' | 'random'
    x_t: str = "gaussian"              # 'zeros' | 'gaussian' (uniform, see above)
    lr: float = 5e-5

    def replace(self, **kw) -> "BaselineConfig":
        return dataclasses.replace(self, **kw)


class BaselineTask:
    """Binds a model to the one-shot regression; the weights live in the model."""

    def __init__(self, model: DiffRollModel, config: BaselineConfig = BaselineConfig(),
                 mesh=None):
        self.model = model
        self.config = config
        self.mesh = mesh
        self.schedule = linear_schedule(config.beta_start, config.beta_end, config.timesteps)

    def dummy_inputs(self, shape, generator: Optional[torch.Generator],
                     device) -> Tuple[torch.Tensor, torch.Tensor]:
        """(x_t, t) for a batch of `shape` (B, T, 88), drawn from `generator`."""
        cfg = self.config
        bsz = shape[0]
        if cfg.time_mode == "constant":
            t = torch.ones(bsz, dtype=torch.long, device=device)
        elif cfg.time_mode == "constant_maxT":
            t = torch.full((bsz,), cfg.timesteps - 1, dtype=torch.long, device=device)
        elif cfg.time_mode == "random":
            t = torch.randint(0, 100, (bsz,), generator=generator, device=device)
        else:
            raise ValueError(f"time_mode {cfg.time_mode!r} is not recognized")
        if cfg.x_t == "zeros":
            x_t = torch.zeros(shape, device=device)
        elif cfg.x_t == "gaussian":
            x_t = torch.rand(shape, generator=generator, device=device)
        else:
            raise ValueError(f"x_t {cfg.x_t!r} is not recognized")
        return x_t, t

    def predict(self, batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None,
                *, x_t: Optional[torch.Tensor] = None,
                t: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The one-shot prediction (B, T, 88): one forward on the dummy
        inputs, drawn from `generator` unless given."""
        return self._forward(batch, generator, x_t, t)[0]

    def _forward(self, batch, generator, x_t, t):
        roll = batch["frame"]
        if x_t is None or t is None:
            mesh = self.mesh
            n = roll.shape[0] if mesh is None else mesh.global_rows(batch, roll.shape[0])
            dx, dt = self.dummy_inputs((n,) + tuple(roll.shape[1:]), generator, roll.device)
            if mesh is not None:
                dx, dt = mesh.stripe(dx), mesh.stripe(dt)
            x_t = dx if x_t is None else x_t
            t = dt if t is None else t
        if roll.shape[0] == 0:
            return roll, None
        cond = self.model.conditioner(waveform=batch["audio"])
        return self.model.apply(x_t, t, cond, None), cond

    def loss_fn(self, batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None,
                train: bool = True, *, x_t: Optional[torch.Tensor] = None,
                t: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, Tuple[Dict[str, torch.Tensor], Dict[str, Any]]]:
        """The MSE of the one-shot prediction against the roll, NOT
        normalised (the reference's quirk); the same signature as
        `DiffusionTask.loss_fn`."""
        del train
        roll = batch["frame"]
        pred, cond = self._forward(batch, generator, x_t, t)
        if roll.shape[0] == 0:  # an empty stripe of a short last batch
            zero = roll.sum()
            return zero, ({"amt_loss": zero}, {})
        losses = {"amt_loss": torch.mean((pred - roll) ** 2)}
        tensors = {"pred_roll": pred, "label_roll": roll, "spec": cond}
        total = sum(losses[k] for k in self.config.loss_keys)
        return total, (losses, tensors)

    @torch.no_grad()
    def sample(self, x_T: torch.Tensor, waveform: Optional[torch.Tensor] = None,
               roll_cond: Optional[torch.Tensor] = None, record_every: Optional[int] = None,
               noise: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None):
        """The evaluation walk: an x0-parameterised DDPM loop over all T
        steps, one forward a step (the network ignores t anyway). The per-step
        draws come as `noise` (T, *x_T.shape) or from `generator` in one
        tensor. Returns (x_0, trajectory or None), as `DiffusionTask.sample`
        (over `self.mesh`, the global batch on rank 0 and None elsewhere)."""
        del roll_cond
        n = self.config.timesteps
        if noise is None:
            if generator is None:
                raise ValueError("the baseline's walk needs `noise` or a `generator`")
            noise = torch.randn((n,) + tuple(x_T.shape), generator=generator,
                                device=x_T.device, dtype=torch.float32)
        if self.mesh is not None:
            if record_every is not None:
                raise ValueError("a trajectory is not sampled over the data axis")
            return self.mesh.sample_stripes(self._sample_rows, x_T, waveform, None, noise), None
        return self._sample_rows(x_T, waveform, None, noise, record_every)

    def _sample_rows(self, x_T, waveform, roll_cond, noise, record_every=None):
        """The walk on this process's rows, the draws given."""
        n = self.config.timesteps
        cond = self.model.conditioner(waveform=waveform)

        def step(x, t, t_prev, n_i):
            t_vec = torch.full((x.shape[0],), t, dtype=torch.long, device=x.device)
            x0 = self.model.apply(x, t_vec, cond, None)
            return ddpm_x0_step(self.schedule, x, t, x0, n_i, t_prev=t_prev)

        return sample_loop(step, x_T, n, noise, record_every=record_every)
