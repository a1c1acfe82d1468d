"""The denoiser forward with the residual stack through the kernels
(counterpart of `diffroll_tpu/ops/fused_forward.py`): K1 for inference, and
with `trainable=` the autograd function over the training kernels.

Numerically the same as `DiffRollNet.forward` up to the kernels' bf16
products; the head and the diffusion embedding are small products in plain
PyTorch around the stack, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..nn.embedding import lookup
from ..nn.resblock import pointwise
from ..parallel.model_axis import column, full_view
from .gated_stack import (
    GatedStackWeights, KernelWeights, gated_stack, kernel_weights, stack_weights)
from .gated_stack_grad import gated_stack_trainable


def supports_fused(model_config) -> bool:
    """The fused path covers the 1-D stack with 'fixed' (spec := -1)
    classifier-free conditioning or no conditioning at all."""
    return model_config.variant == "1d" and (
        model_config.condition == "fixed" or model_config.unconditional)


class HeadWeights(NamedTuple):
    """The non-stack 1x1 convs of DiffRollNet as (in, out) f32 matrices."""

    win: torch.Tensor    # (88, C) input_projection
    bin: torch.Tensor    # (C,)
    wskip: torch.Tensor  # (C, C) skip_projection
    bskip: torch.Tensor  # (C,)
    wout: torch.Tensor   # (C, 88) output_projection
    bout: torch.Tensor   # (88,)


def head_weights(net) -> HeadWeights:
    def mat(conv):
        return conv.weight[:, :, 0].t().detach().contiguous()

    return HeadWeights(
        win=mat(net.input_projection), bin=net.input_projection.bias.detach(),
        wskip=mat(net.skip_projection), bskip=net.skip_projection.bias.detach(),
        wout=mat(net.output_projection), bout=net.output_projection.bias.detach())


def _embed(t: torch.Tensor, emb) -> torch.Tensor:
    """DiffusionEmbedding's forward (table lookup/lerp + two SiLU linears;
    column-parallel under a model axis)."""
    e = lookup(emb.embedding, t)
    e = F.silu(column(emb.projection1, e, F.linear, -1))
    return F.silu(column(emb.projection2, e, F.linear, -1))


class FusedOperands(NamedTuple):
    """A `DiffRollNet`'s weights as the fused inference routes read them:
    the stacked f32 weights with the diffusion projections `wt`/`bt`, the
    head's matrices, and the kernels' bf16 operands (None off the card).
    Built by `of` from the whole weights; they go stale when the weights
    change, and the holder rebuilds them."""

    weights: GatedStackWeights
    head: HeadWeights
    kernel: Optional[KernelWeights]

    @classmethod
    def of(cls, net) -> "FusedOperands":
        """The operands of `net` as it is now: its whole weights (gathered
        under a model axis), read without autograd."""
        with torch.no_grad(), full_view(net):
            layers = list(net.residual_layers)
            w = stack_weights(net)._replace(
                wt=torch.stack([l.diffusion_projection.weight.t() for l in layers]),
                bt=torch.stack([l.diffusion_projection.bias for l in layers]))
            return cls(w, head_weights(net), kernel_weights(w) if w.wd.is_cuda else None)

    def time_bias(self, t_emb: torch.Tensor) -> torch.Tensor:
        """Every layer's FiLM bias in one einsum: (N, E) -> (L, N, C)."""
        return torch.einsum("ne,lec->lnc", t_emb, self.weights.wt) + self.weights.bt[:, None, :]

    def step_biases(self, net, ts: np.ndarray) -> torch.Tensor:
        """The FiLM biases of a reverse process's steps `ts`, (n, L, C), as
        the whole-process sampler reads them."""
        w = self.weights
        with torch.no_grad(), full_view(net):
            t_emb = _embed(torch.from_numpy(ts.astype(np.int64)).to(w.wd.device),
                           net.diffusion_embedding)                          # (n, E)
            return torch.einsum("ne,lec->nlc", t_emb, w.wt) + w.bt[None]


def head_stack(x_t, t_bias, cond, w: GatedStackWeights, head: HeadWeights,
               dilations: Sequence[int], stack=gated_stack, **stack_kw):
    """relu(x_t @ Win + bin) -> the stack -> relu(. @ Wskip + bskip) @ Wout + bout."""
    x = torch.relu(x_t @ head.win + head.bin)
    skip = stack(x, t_bias, cond if w.wc is not None else None, w, dilations,
                 **stack_kw)
    return torch.relu(skip @ head.wskip + head.bskip) @ head.wout + head.bout


def fused_forward(
    net,
    x_t: torch.Tensor,
    t: torch.Tensor,
    cond: Optional[torch.Tensor],
    *,
    dilations: Sequence[int],
    operands: Optional[FusedOperands] = None,
    trainable: Optional[str] = None,
    need_dcond: bool = True,
) -> torch.Tensor:
    """x_t (B, T, 88), t (B,), cond (B, T, M) already substituted (-1 rows
    for unconditional CFG branches) or None -> (B, T, 88).

    Pass `operands` (`FusedOperands.of(net)`) to reuse them across sampler
    steps; without them they are prepared from `net` for this one call.

    `trainable=` an impl of `gated_stack_grad` ('plain', 'cuda') is the
    training route: everything reads the module's parameters under autograd,
    the per-layer FiLM biases and the heads in plain PyTorch, the stack
    through `GatedStackFn`.
    """
    if trainable is not None:
        x = torch.relu(pointwise(x_t, net.input_projection))
        t_emb = _embed(t, net.diffusion_embedding)
        layers = list(net.residual_layers)
        t_bias = torch.stack([l.diffusion_projection(t_emb) for l in layers])  # (L, B, C)
        w = stack_weights(net)
        if cond is None:
            w = w._replace(wc=None, bc=None)
        skip = gated_stack_trainable(x, t_bias, cond if w.wc is not None else None, w,
                                     dilations, trainable, need_dcond)
        return pointwise(torch.relu(pointwise(skip, net.skip_projection)),
                         net.output_projection)
    ops = FusedOperands.of(net) if operands is None else operands
    t_bias = ops.time_bias(_embed(t, net.diffusion_embedding))
    return head_stack(x_t, t_bias, cond, ops.weights, ops.head, dilations, kweights=ops.kernel)
