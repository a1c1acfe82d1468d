"""Sequence (time-axis) parallelism with a halo exchange (counterpart of
`diffroll_tpu/parallel/context.py`).

The 1-D DiffRoll denoiser is convolutional in time with a small receptive
field per layer (d * (k // 2) frames, at most 8 for the flagship), so one
clip's time axis splits over the ranks of a mesh axis: rank i holds frames
[i T/n, (i + 1) T/n), and before each residual block it takes the d * (k // 2)
frames of x beside its block from its neighbours; the block runs over the
extended frames (its own zero padding at the sequence's ends) and keeps
its block's. The exchange is an all-reduce of a zero buffer in which
each rank fills its slot with its edge frames (adding zeros is exact), so it
runs alike on gloo (the CPU; CUDA tensors) and on NCCL; no point-to-point.

The stack is the net's own `forward` and `ResidualBlock`s in plain PyTorch,
as the JAX version computes in XLA einsums (no kernel). The conditioner and the
sampler step are the task's (`build_conditioner`, `make_step_fn_from_net`),
as in the dense sampler. The net must be whole (not sharded over a model
axis). No entry point uses it; the JAX package has no CLI for it either.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..diffusion.loop import sample_loop, timestep_subsequence
from ..diffusion.samplers import SAMPLER_TABLE
from .mesh import Mesh
from .model_axis import is_sharded


class _SeqAxis:
    """This rank's block of a T-frame sequence on one axis of the mesh."""

    def __init__(self, mesh: Mesh, axis: str, frames: int, net):
        if axis not in ("data", "model"):
            raise ValueError(f"axis {axis!r}: 'data' or 'model'")
        if not hasattr(net, "residual_layers") or not hasattr(net, "skip_projection") or \
                net.residual_layers[0].dilated_conv.weight.ndim != 3:
            raise ValueError("sequence parallelism runs the 1-D DiffRoll net")
        if is_sharded(net):
            raise ValueError("sequence parallelism needs the net's whole weights")
        self.group = mesh.data_group if axis == "data" else mesh.model_group
        self.n = mesh.data if axis == "data" else mesh.model
        self.index = mesh.data_index if axis == "data" else mesh.model_index
        if frames % self.n:
            raise ValueError(f"T={frames} does not divide over the {axis} axis of {self.n}")
        self.frames, self.local = frames, frames // self.n
        self.start = self.index * self.local
        self.halo = max(_halo(blk) for blk in net.residual_layers)
        # each layer's halo reaches only the immediate neighbour
        if self.local < self.halo:
            raise ValueError(f"sequence-parallel shard of {self.local} frames cannot cover the "
                             f"max conv halo of {self.halo}; need T/{axis}_size >= {self.halo} "
                             f"(T={frames}, {axis}={self.n})")

    def block(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's frames of a (B, T, ...) tensor."""
        return x[:, self.start:self.start + self.local]

    def exchange(self, y: torch.Tensor, halo: int):
        """(B, Tl, C) block -> its neighbours' `halo` edge frames beside it
        (left, right), None at the sequence's ends (and for no halo)."""
        if not halo:
            return None, None
        buf = y.new_zeros((self.n, 2, y.shape[0], halo, y.shape[2]))
        buf[self.index, 0] = y[:, :halo]
        buf[self.index, 1] = y[:, -halo:]
        dist.all_reduce(buf, group=self.group)
        left = buf[self.index - 1, 1] if self.index > 0 else None
        right = buf[self.index + 1, 0] if self.index < self.n - 1 else None
        return left, right

    def gather(self, y: torch.Tensor) -> torch.Tensor:
        """Every rank's block -> the whole (B, T, ...) tensor on every rank."""
        buf = y.new_zeros((y.shape[0], self.frames) + tuple(y.shape[2:]))
        self.block(buf).copy_(y)
        dist.all_reduce(buf, group=self.group)
        return buf


def _halo(block) -> int:
    conv = block.dilated_conv
    return conv.dilation[0] * (conv.kernel_size[0] // 2)


def _local_forward(net, x_t, t, cond, sp: _SeqAxis) -> torch.Tensor:
    """`DiffRollNet.forward` on this rank's block x_t (B, Tl, 88); `cond`
    (B, T, M) is whole, or None. Each `ResidualBlock` runs over its block
    extended by the neighbours' halo frames of x (its own zero padding at
    the sequence's ends, as in the whole forward), and keeps the block's
    frames."""
    lo = max(sp.start - sp.halo, 0)
    cond_proj = None
    if cond is not None and not net.unconditional:
        cond_proj = net.cond_projections(cond[:, lo:sp.start + sp.local + sp.halo])

    def layer(block, x, t_emb, proj):
        left, right = sp.exchange(x, _halo(block))
        a = 0 if left is None else left.shape[1]
        ext = torch.cat([v for v in (left, x, right) if v is not None], dim=1)
        if proj is not None:
            proj = proj[:, sp.start - a - lo:][:, :ext.shape[1]]
        y, skip = block(ext, t_emb, proj)
        return y[:, a:a + sp.local], skip[:, a:a + sp.local]

    return net(x_t, t, cond_proj=cond_proj, layer=layer)


def sequence_parallel_forward(mesh: Mesh, net, x_t: torch.Tensor, t: torch.Tensor,
                              cond: Optional[torch.Tensor], axis: str = "data") -> torch.Tensor:
    """The denoiser's forward with the TIME axis split over `mesh`'s `axis`.

    x_t (B, T, 88) and cond (B, T, M) or None are whole on every rank of the
    axis, and so is the output (B, T, 88); each rank computes its T/n frames.
    T must divide by the axis's size, and a block must cover the largest
    halo."""
    sp = _SeqAxis(mesh, axis, x_t.shape[1], net)
    out = _local_forward(net, sp.block(x_t), t, cond, sp)
    return sp.gather(out)


@torch.no_grad()
def sample_sequence_parallel(task, x_T: torch.Tensor, mesh: Mesh,
                             waveform: Optional[torch.Tensor] = None,
                             generator: Optional[torch.Generator] = None,
                             axis: str = "data", noise: Optional[torch.Tensor] = None):
    """The reverse process of ONE long window (or a few) with its time axis
    split over `mesh`'s `axis`: per-clip latency falls with the ranks.
    x_T (B, T, 88) and `waveform` are whole on every rank; the per-step
    noise is `noise` (n, B, T, 88) or drawn whole from `generator`, so every
    rank draws alike and keeps its frames. Returns (x_0 whole on every
    rank, None)."""
    cfg = task.config
    net = task.model.net
    sp = _SeqAxis(mesh, axis, x_T.shape[1], net)
    if not SAMPLER_TABLE[cfg.sampling_type][3]:
        noise = None
    elif noise is None:
        if generator is None:
            raise ValueError(f"{cfg.sampling_type} needs `noise` or a `generator`")
        n = len(timestep_subsequence(cfg.timesteps, cfg.sampling_steps))
        noise = torch.randn((n,) + tuple(x_T.shape), generator=generator, device=x_T.device)
    # the task's conditioner (inpainting masks, the generation spec := -1)
    # and its CFG step plumbing, shared with the dense sampler
    cond = task.build_conditioner(x_T, waveform=waveform)
    step = task.make_step_fn_from_net(lambda x, t, c: _local_forward(net, x, t, c, sp), cond)
    x0, _ = sample_loop(step, sp.block(x_T), cfg.timesteps,
                        None if noise is None else noise[:, :, sp.start:sp.start + sp.local],
                        steps=cfg.sampling_steps)
    return sp.gather(x0), None
