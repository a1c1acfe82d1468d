"""The denoiser forward with the residual stack through K1 (counterpart of
`diffroll_tpu/ops/fused_forward.py`, inference branch).

Numerically the same as `DiffRollNet.forward` up to the kernel's bf16
products; the head and the diffusion embedding are small products in plain
PyTorch around the stack, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F

from ..nn.embedding import lookup
from .gated_stack import (
    GatedStackWeights, KernelWeights, gated_stack, kernel_weights, stack_weights)


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
    """DiffusionEmbedding's forward (table lookup/lerp + two SiLU linears)."""
    e = lookup(emb.embedding, t)
    e = F.silu(F.linear(e, emb.projection1.weight, emb.projection1.bias))
    return F.silu(F.linear(e, emb.projection2.weight, emb.projection2.bias))


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
) -> torch.Tensor:
    """x_t (B, T, 88), t (B,), cond (B, T, M) already substituted (-1 rows
    for unconditional CFG branches) or None -> (B, T, 88).

    Pass `weights`, `kweights` (needed on CUDA) and `head` to reuse them
    across sampler steps; without `weights` all three are prepared from
    `net` for this one call.
    """
    if weights is None:
        weights = stack_weights(net)
        kweights = kernel_weights(weights) if x_t.is_cuda else None
    h = head_weights(net) if head is None else head
    t_bias = time_bias(_embed(t, net.diffusion_embedding), weights)
    return head_stack(x_t, t_bias, cond, weights, h, dilations, kweights=kweights)
