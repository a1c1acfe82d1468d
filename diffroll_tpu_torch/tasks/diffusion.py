"""Spec-conditioned piano-roll diffusion (counterpart of
`diffroll_tpu/tasks/diffusion.py`): the training losses and the sampler.

`DiffusionTask.loss_fn` is one training step's losses. With
`fused_train=true` and a model family the fused op covers, the residual
stack runs through `GatedStackFn` (ops/gated_stack_grad.py): on a CUDA
model through the forward-with-saves and backward kernels (K3 + K4), on a
CPU model through their plain versions. Otherwise the forward is the plain
`nn.Module` under autograd.

`DiffusionTask.sample` runs the whole reverse process. With tensors on a
CUDA device and a model family the kernels cover, it dispatches to the
whole-process sampler (ops/sampler_kernel.py, kernel K2); with a trajectory
requested or `use_megakernel=False` it runs the step loop, whose forward
goes through the gated-stack kernel (K1) when `use_fused` resolves. On CPU
both routes run their plain PyTorch versions.

The model families the kernels do not cover (`supports_fused` is false:
trainable conditioning, the 2-D net, the U-Nets) take the `nn.Module` path
in both, as the JAX package takes XLA. The step loop's module path computes
what depends on the conditioner alone once a batch (`cond_projections`, for
both guidance branches `cfg_cond_projections`) and hands it to every step's
forward as `cond_proj`: the stacks' per-layer conditioner projections, and
SpecUnet's whole spectrogram stream, which reads neither x nor t, so that a
step runs its x stream alone. The unconditional `UnetNet` has no
conditioner and runs its forward every step.

With a data axis (`mesh`, parallel/mesh.py) the task's draws are the
global batch's, striped: `loss_fn` draws t, noise and the dropout mask for
the global batch and keeps this rank's rows, and `sample` draws the global
batch's per-step noise, samples this rank's rows and gathers the rolls to
rank 0, so both equal the single-process run on the same global batch.
Under a model axis (the net's parameters sharded, parallel/model_axis.py)
the `nn.Module` route is column-parallel, and the kernel routes build their
operands from the whole weights, gathered: once a training step, and once
for the sampler's prepared operands.

Guidance note (as in the JAX package): the unconditional branch of every
guided sampler, cfdg_ddim_x0 included, conditions on spec := -1.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..diffusion.forward import extract_x0, q_sample
from ..diffusion.loop import previous_timesteps, sample_loop, timestep_subsequence
from ..diffusion.samplers import SAMPLER_TABLE, cfg_mix
from ..diffusion.schedule import Schedule, linear_schedule
from ..models.base import DiffRollModel
from ..models.conditioning import spec_dropout_mask
from ..ops.fused_forward import FusedOperands, fused_forward, supports_fused
from ..ops.sampler_kernel import fused_sample, sampler_tables
from ..parallel.model_axis import full_view
from ..utils.profiling import span
from .losses import p_losses


@dataclasses.dataclass(frozen=True)
class TaskConfig:
    """Same fields and defaults as `diffroll_tpu.tasks.diffusion.TaskConfig`."""

    timesteps: int = 200
    sampling_steps: Optional[int] = None
    beta_start: float = 1e-4
    beta_end: float = 0.02
    loss_type: str = "l2"
    loss_keys: Tuple[str, ...] = ("diffusion_loss",)
    training_mode: str = "x_0"
    sampling_type: str = "cfdg_ddpm_x0"
    w: float = 0.0
    frame_threshold: float = 0.5
    generation_filter: float = 0.0
    inpainting_t: Optional[Sequence[int]] = None
    inpainting_f: Optional[Sequence[int]] = None
    debug: bool = False
    lr: float = 5e-5
    # the step loop's forward through the gated-stack kernel; None = auto
    use_fused: Optional[bool] = None
    # the whole-process sampler; None = auto (CUDA tensors, a supported
    # model family, no trajectory requested, use_fused not False)
    use_megakernel: Optional[bool] = None
    # training through the autograd function over the fused stack
    # (ops/gated_stack_grad.py). Opt-in, as in the JAX package; None = off.
    fused_train: Optional[bool] = None

    def replace(self, **kw) -> "TaskConfig":
        return dataclasses.replace(self, **kw)


class SamplerOperands(NamedTuple):
    """What the fused sampling routes read, kept on the device, so a reverse
    process copies nothing from the host for them (such a copy from pageable
    memory waits for the stream, and so for the batch before it): the net's
    prepared operands, the whole-process sampler's per-step tables (n, 3),
    its FiLM biases t_bias (n, L, C), and whether it draws noise."""

    device: torch.device
    operands: FusedOperands
    tables: torch.Tensor
    t_bias: torch.Tensor
    stochastic: bool


class DiffusionTask:
    """Binds a model to the diffusion process; the weights live in the model.

    The sampling routes' operands are prepared once and kept (`_fused`, see
    `sampler_operands`): rebuilt when the net moves to another device, and
    dropped by every `loss_fn(train=True)`, since training moves the weights.
    """

    def __init__(self, model: DiffRollModel, config: TaskConfig = TaskConfig(), mesh=None):
        self.model = model
        self.config = config
        self.mesh = mesh
        self.schedule: Schedule = linear_schedule(
            config.beta_start, config.beta_end, config.timesteps)
        if config.sampling_type not in SAMPLER_TABLE:
            raise KeyError(f"unknown sampler {config.sampling_type!r}; "
                           f"choices: {sorted(SAMPLER_TABLE)}")
        self._fused: Optional[SamplerOperands] = None

    def sampler_operands(self) -> SamplerOperands:
        """The operands of the fused sampling routes for the net's weights
        as they are, built from the whole weights on first use."""
        net = self.model.net
        dev = net.input_projection.weight.device
        if self._fused is None or self._fused.device != dev:
            cfg = self.config
            ops = FusedOperands.of(net)
            ts = timestep_subsequence(cfg.timesteps, cfg.sampling_steps)
            tables = sampler_tables(self.schedule, cfg.sampling_type, ts, previous_timesteps(ts))
            self._fused = SamplerOperands(dev, ops, torch.from_numpy(tables).to(dev),
                                          ops.step_biases(net, ts),
                                          bool(np.any(tables[:, 2] != 0.0)))
        return self._fused

    # ------------------------------------------------------------- training

    def _conditioner(self, batch: Dict[str, torch.Tensor], roll: torch.Tensor):
        if self.config.debug or self.model.config.cond_source == "roll":
            return roll
        return self.model.conditioner(
            waveform=batch["audio"],
            inpainting_t=self.config.inpainting_t,
            inpainting_f=self.config.inpainting_f)

    def _forward_train(self, x_t, t, cond, uncond_mask, impl=None):
        """The training-loss forward. The fused route applies the 'fixed'
        unconditional substitution (spec := -1 on dropped rows) to the raw
        conditioner, as `DiffRollNet.cond_projections` does. `impl` names its
        route (an impl of ops/gated_stack_grad.py); None = 'cuda' (both
        kernels) for CUDA tensors, 'plain' for CPU ones."""
        mc = self.model.config
        if not (self.config.fused_train and supports_fused(mc)):
            return self.model.apply(x_t, t, cond, uncond_mask)
        c = cond
        if c is not None:
            if uncond_mask is not None:
                c = torch.where(uncond_mask[:, None, None], torch.full_like(c, -1.0), c)
            # the conditioner is derived from data (the mel front end has no
            # parameters), so its gradient is never used
            c = c.detach()
        with full_view(self.model.net) as net:   # the kernels take whole weights
            if not torch.is_grad_enabled():
                # validation: no backward follows, so the inference forward (K1
                # on a CUDA model) serves, with operands prepared for this call
                return fused_forward(net, x_t, t, c, dilations=mc.dilations())
            return fused_forward(net, x_t, t, c, dilations=mc.dilations(),
                                 trainable=impl or ("cuda" if x_t.is_cuda else "plain"),
                                 need_dcond=False)

    def loss_fn(
        self,
        batch: Any,
        generator: Optional[torch.Generator] = None,
        train: bool = True,
        *,
        t: Optional[torch.Tensor] = None,
        noise: Optional[torch.Tensor] = None,
        uncond_mask: Optional[torch.Tensor] = None,
        impl: Optional[str] = None,
    ) -> Tuple[torch.Tensor, Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]]:
        """One step's total loss + (losses dict, tensors dict).

        `batch` is {'frame': (B, 640, 88), 'audio': (B, L)} on the model's
        device, or a pair of such dicts for the dual-dataset recipe. The
        timesteps, the noise and the spec-dropout mask are drawn from
        `generator` (on the model's device) unless given; given ones are this
        rank's rows. `impl` picks the route of `fused_train` (see
        `_forward_train`); the default is both kernels on a CUDA model.
        """
        cfg = self.config
        if train:
            self._fused = None
        dual = isinstance(batch, (tuple, list))
        b1 = batch[0] if dual else batch

        roll = self.model.normalize_roll(b1["frame"])
        bsz, dev = roll.shape[0], roll.device
        mesh = self.mesh
        # the global batch's draws, this rank's rows of them (parallel/mesh.py)
        n = bsz if mesh is None else mesh.global_rows(batch, bsz)
        stripe = (lambda x: x) if mesh is None else mesh.stripe
        if t is None:
            t = stripe(torch.randint(0, cfg.timesteps, (n,), generator=generator, device=dev))
        if noise is None:
            noise = stripe(torch.randn((n,) + tuple(roll.shape[1:]), generator=generator,
                                       device=dev, dtype=roll.dtype))
        mc = self.model.config
        # `_conditioner` gives None only without a conditioner at all
        has_cond = (self.config.debug or mc.cond_source == "roll"
                    or not (mc.cond_source == "none" or mc.unconditional))
        p = mc.spec_dropout
        drop = train and p > 0 and has_cond
        if drop and uncond_mask is None:
            uncond_mask = stripe(spec_dropout_mask(n, p, generator, dev))
        if bsz == 0:
            # an empty stripe of a short last batch: the draws above keep the
            # generator in step with the other ranks; nothing to evaluate
            zero = roll.sum()
            keys = ("diffusion_loss",) + (("unconditional_diffusion_loss",) if dual else ())
            return zero, ({k: zero for k in keys}, {})
        x_t = q_sample(roll, t, self.schedule, noise)

        cond = self._conditioner(b1, roll)
        if not (drop and cond is not None):
            uncond_mask = None

        pred = self._forward_train(x_t, t, cond, uncond_mask, impl)

        losses: Dict[str, torch.Tensor] = {}
        if cfg.training_mode == "epsilon":
            losses["diffusion_loss"] = p_losses(noise, pred, cfg.loss_type)
            pred_roll = extract_x0(x_t, pred, t, self.schedule)
        elif cfg.training_mode == "x_0":
            losses["diffusion_loss"] = p_losses(roll, pred, cfg.loss_type)
            pred_roll = pred
        elif cfg.training_mode == "ex_0":
            pred_roll = extract_x0(x_t, pred, t, self.schedule)
            losses["diffusion_loss"] = p_losses(roll, pred_roll, cfg.loss_type)
        else:
            raise ValueError(f"training mode {cfg.training_mode!r} not supported")

        tensors = {"pred_roll": pred_roll, "label_roll": roll, "spec": cond}

        if dual:
            # the second dataset trains the unconditional branch: same t and
            # noise, spec forced unconditional
            b2 = batch[1]
            roll2 = self.model.normalize_roll(b2["frame"])
            x_t2 = q_sample(roll2, t, self.schedule, noise)
            cond2 = self._conditioner(b2, roll2)
            all_uncond = torch.ones(bsz, dtype=torch.bool, device=dev)
            pred2 = self._forward_train(x_t2, t, cond2, all_uncond, impl)
            losses["unconditional_diffusion_loss"] = p_losses(roll2, pred2, cfg.loss_type)
            tensors.update({"pred_roll2": pred2, "label_roll2": roll2, "spec2": cond2})

        # validation batches of a dual-dataset run are single-dataset: sum
        # only the loss keys that were produced
        total = sum(losses[k] for k in cfg.loss_keys if k in losses)
        return total, (losses, tensors)

    # ------------------------------------------------------------- sampling

    def build_conditioner(
        self,
        x_T: torch.Tensor,
        waveform: Optional[torch.Tensor] = None,
        roll_cond: Optional[torch.Tensor] = None,
    ) -> Optional[torch.Tensor]:
        """The sampler's conditioner, computed once per clip: log-mel with
        inpainting masks, the roll in debug mode, or the trained spec := -1
        embedding for generation from noise on a conditional model."""
        mc = self.model.config
        if mc.unconditional:
            return None
        if self.config.debug or mc.cond_source == "roll":
            return roll_cond
        if waveform is not None:
            return self.model.conditioner(
                waveform=waveform,
                inpainting_t=self.config.inpainting_t,
                inpainting_f=self.config.inpainting_f)
        if mc.cond_source == "spec":
            return torch.full((x_T.shape[0], x_T.shape[1], mc.n_mels), -1.0,
                              device=x_T.device)
        return None

    def make_step_fn_from_net(self, net, cond: Optional[torch.Tensor]):
        """Step closure over `net(x, t_vec, cond) -> pred`: the CFG /
        generation plumbing of the fused route."""
        cfg = self.config
        step_fn, _, guided, _ = SAMPLER_TABLE[cfg.sampling_type]
        generation = cfg.sampling_type.startswith("generation")
        schedule = self.schedule

        if cond is None or self.model.config.unconditional:
            def predict(x, t_vec):
                return net(x, t_vec, None)
        elif generation:
            uncond = torch.full_like(cond, -1.0)

            def predict(x, t_vec):
                return net(x, t_vec, uncond)
        elif guided:
            cond2 = torch.cat([cond, torch.full_like(cond, -1.0)])

            def predict(x, t_vec):
                b = x.shape[0]
                out = net(torch.cat([x, x]), torch.cat([t_vec, t_vec]), cond2)
                return cfg_mix(out[:b], out[b:], cfg.w)
        else:
            def predict(x, t_vec):
                return net(x, t_vec, cond)

        def step(x, t, t_prev, noise):
            t_vec = torch.full((x.shape[0],), t, dtype=torch.long, device=x.device)
            return step_fn(schedule, x, t, predict(x, t_vec), noise, t_prev=t_prev)

        return step

    def make_step_fn(self, cond: Optional[torch.Tensor]):
        """The `(x, t, t_prev, noise) -> x_{t_prev}` closure for `sample_loop`."""
        cfg = self.config
        step_fn, _, guided, _ = SAMPLER_TABLE[cfg.sampling_type]
        model, schedule = self.model, self.schedule
        mc = model.config
        generation = cfg.sampling_type.startswith("generation")
        fused = supports_fused(mc) if cfg.use_fused is None else (
            cfg.use_fused and supports_fused(mc))

        if fused:
            ops = self.sampler_operands().operands

            def net(x, t_vec, c):
                return fused_forward(model.net, x, t_vec, c, dilations=mc.dilations(),
                                     operands=ops)

            return self.make_step_fn_from_net(net, cond)

        # the plain module path, conditioner projections precomputed per clip;
        # the unconditional UnetNet, which reads no conditioner, has none
        if cond is None or mc.unconditional or not hasattr(model.net, "cond_projections"):
            proj = None
        elif generation:
            proj = model.cond_projections(
                cond, torch.ones(cond.shape[0], dtype=torch.bool, device=cond.device))
        elif guided:
            proj = model.cfg_cond_projections(cond)
        else:
            proj = model.cond_projections(cond)

        def predict(x, t_vec):
            if proj is None:
                return model.apply(x, t_vec, None)
            if guided:
                return cfg_mix(*model.apply_cfg(x, t_vec, cond_proj=proj), cfg.w)
            return model.apply(x, t_vec, None, cond_proj=proj)

        def step(x, t, t_prev, noise):
            t_vec = torch.full((x.shape[0],), t, dtype=torch.long, device=x.device)
            return step_fn(schedule, x, t, predict(x, t_vec), noise, t_prev=t_prev)

        return step

    @torch.no_grad()
    def sample(
        self,
        x_T: torch.Tensor,
        waveform: Optional[torch.Tensor] = None,
        roll_cond: Optional[torch.Tensor] = None,
        record_every: Optional[int] = None,
        noise: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ):
        """Full reverse process. Returns (x_0, trajectory or None).

        Stochastic samplers take their per-step draws as `noise`
        (n, *x_T.shape), or draw them in one tensor from `generator`, so
        both routes consume the same numbers. Deterministic samplers draw
        none.

        Over the task's data axis (`self.mesh`) x_T, waveform, roll_cond and
        noise are the global batch's: this rank samples its rows rank::size
        and rank 0 gets the whole batch back as a CPU tensor, every other
        rank None.
        """
        with span("sample"):
            cfg = self.config
            n = len(timestep_subsequence(cfg.timesteps, cfg.sampling_steps))
            if not SAMPLER_TABLE[cfg.sampling_type][3]:
                noise = None
            elif noise is None:
                if generator is None:
                    raise ValueError(f"{cfg.sampling_type} needs `noise` or a `generator`")
                with span("sample.draw"):
                    noise = torch.randn((n,) + tuple(x_T.shape), generator=generator,
                                        device=x_T.device, dtype=torch.float32)
            if self.mesh is not None:
                if record_every is not None:
                    raise ValueError("a trajectory is not sampled over the data axis")
                return self.mesh.sample_stripes(self._sample_rows, x_T, waveform, roll_cond,
                                                noise), None
            return self._sample_rows(x_T, waveform, roll_cond, noise, record_every)

    def _sample_rows(self, x_T, waveform, roll_cond, noise, record_every=None):
        """The reverse process on this process's rows, the draws given."""
        cfg = self.config
        cond = self.build_conditioner(x_T, waveform, roll_cond)
        if record_every is None and self._megakernel_applies(x_T.device):
            return self._sample_megakernel(x_T, cond, noise), None
        return sample_loop(self.make_step_fn(cond), x_T, cfg.timesteps, noise,
                           steps=cfg.sampling_steps, record_every=record_every)

    def _megakernel_applies(self, device: torch.device) -> bool:
        cfg = self.config
        if cfg.use_megakernel is not None:
            return bool(cfg.use_megakernel) and supports_fused(self.model.config)
        return (device.type == "cuda" and cfg.use_fused is not False
                and supports_fused(self.model.config))

    def _sample_megakernel(self, x_T, cond, noise):
        """The whole reverse process through `fused_sample` (the kernels on
        CUDA tensors, the plain version on CPU tensors)."""
        with span("sample.k2"):
            cfg = self.config
            mc = self.model.config
            _, _, guided, _ = SAMPLER_TABLE[cfg.sampling_type]
            generation = cfg.sampling_type.startswith("generation")
            so = self.sampler_operands()
            ops = so.operands
            if cond is not None and generation:
                cond = torch.full_like(cond, -1.0)
            return fused_sample(
                x_T, noise if so.stochastic else None, so.t_bias, so.tables, ops.weights,
                ops.head, cond, mc.dilations(), guided=bool(guided and cond is not None),
                w_guidance=float(cfg.w), stochastic=so.stochastic, kweights=ops.kernel)
