"""The denoiser forward with the residual stack through the kernels
(counterpart of `diffroll_tpu/ops/fused_forward.py`): K1 for inference, and
with `trainable=` the autograd function over the training kernels.

Numerically the same as `DiffRollNet.forward` up to the kernels' bf16
products; the head and the diffusion embedding are small products in plain
PyTorch around the stack, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F

from ..nn.embedding import lookup
from ..nn.resblock import pointwise
from ..parallel.model_axis import column
from .gated_stack import (
    COND_PAD, GatedStackWeights, KernelWeights, gated_stack, kernel_weights, stack_weights)
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


def time_bias(t_emb: torch.Tensor, w: GatedStackWeights) -> torch.Tensor:
    """Every layer's FiLM bias in one einsum: (N, E) -> (L, N, C)."""
    return torch.einsum("ne,lec->lnc", t_emb, w.wt) + w.bt[:, None, :]


def head_stack(x_t, t_bias, cond, w: GatedStackWeights, head: HeadWeights,
               dilations: Sequence[int], stack=gated_stack, **stack_kw):
    """relu(x_t @ Win + bin) -> the stack -> relu(. @ Wskip + bskip) @ Wout + bout."""
    x = torch.relu(x_t @ head.win + head.bin)
    skip = stack(x, t_bias, cond if w.wc is not None else None, w, dilations,
                 **stack_kw)
    return torch.relu(skip @ head.wskip + head.bskip) @ head.wout + head.bout


def train_stack_weights(net, conditional: bool, cond_pad: int = COND_PAD) -> GatedStackWeights:
    """`stack_weights` under autograd: the layers' parameters stacked with
    `torch.stack` (its backward is one copy per layer), so the gradients
    arrive on the `nn.Module` parameters in their reference layouts (Conv1d
    (O, I, K), Linear (O, I)). The conditioner rows are zero-padded to
    `cond_pad` with `F.pad`, whose backward drops the padding rows again."""
    layers = list(net.residual_layers)

    def stack(fn):
        return torch.stack([fn(l) for l in layers])

    wc = bc = None
    if conditional:
        wc = stack(lambda l: l.conditioner_projection.weight[:, :, 0].t())
        wc = F.pad(wc, (0, 0, 0, max(cond_pad - wc.shape[1], 0)))
        bc = stack(lambda l: l.conditioner_projection.bias)
    return GatedStackWeights(
        wd=stack(lambda l: l.dilated_conv.weight.permute(2, 1, 0)), wc=wc,
        wo=stack(lambda l: l.output_projection.weight[:, :, 0].t()),
        b=stack(lambda l: l.dilated_conv.bias), bc=bc,
        bo=stack(lambda l: l.output_projection.bias), wt=None, bt=None)


def fused_forward(
    net,
    x_t: torch.Tensor,
    t: torch.Tensor,
    cond: Optional[torch.Tensor],
    *,
    dilations: Sequence[int],
    weights: Optional[GatedStackWeights] = None,
    kweights: Optional[KernelWeights] = None,
    head: Optional[HeadWeights] = None,
    trainable: Optional[str] = None,
    need_dcond: bool = True,
) -> torch.Tensor:
    """x_t (B, T, 88), t (B,), cond (B, T, M) already substituted (-1 rows
    for unconditional CFG branches) or None -> (B, T, 88).

    Pass `weights`, `kweights` (needed on CUDA) and `head` to reuse them
    across sampler steps; without `weights` all three are prepared from
    `net` for this one call.

    `trainable=` an impl of `gated_stack_grad` ('plain', 'cuda', 'cuda_fwd')
    is the training route: everything reads the module's parameters under
    autograd, the per-layer FiLM biases and the heads in plain PyTorch, the
    stack through `GatedStackFn`.
    """
    if trainable is not None:
        x = torch.relu(pointwise(x_t, net.input_projection))
        t_emb = _embed(t, net.diffusion_embedding)
        layers = list(net.residual_layers)
        conditional = hasattr(layers[0], "conditioner_projection") and cond is not None
        t_bias = torch.stack([l.diffusion_projection(t_emb) for l in layers])  # (L, B, C)
        w = train_stack_weights(net, conditional)
        skip = gated_stack_trainable(x, t_bias, cond if conditional else None, w,
                                     dilations, trainable, need_dcond)
        return pointwise(torch.relu(pointwise(skip, net.skip_projection)),
                         net.output_projection)
    if weights is None:
        weights = stack_weights(net)
        kweights = kernel_weights(weights) if x_t.is_cuda else None
    h = head_weights(net) if head is None else head
    t_bias = time_bias(_embed(t, net.diffusion_embedding), weights)
    return head_stack(x_t, t_bias, cond, weights, h, dilations, kweights=kweights)
