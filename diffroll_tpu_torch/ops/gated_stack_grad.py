"""The trainable gated stack: `torch.autograd.Function` around the
forward-with-saves and the backward (counterpart of
`diffroll_tpu/ops/gated_stack_grad.py`; the layer math and the derivation
of the backward are in that module's docstring).

`impl` names the route, as in the JAX package:
  'plain'  plain forward-with-saves + plain backward (any device; the
           semantic reference, the JAX package's 'xla')
  'cuda'   the forward kernel + the backward kernel ('pallas')
The kernel route goes through the wrappers of `gated_stack_train`, which
launch the kernels on CUDA tensors (or raise) and run the plain versions on
CPU tensors. The bf16 operands are rebuilt from the weights on every
forward call, because in training the weights change every step; the
backward kernel reads the same rounded values.

The weights come in stacked on a leading L axis (`GatedStackWeights`
layouts). The caller stacks the per-layer parameters under autograd with
`torch.stack`, whose backward is a handful of copies.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from .gated_stack import GatedStackWeights, KernelWeights, kernel_weights
from .gated_stack_train import bwd, bwd_ref, fwd_saves, fwd_saves_ref

IMPLS = ("plain", "cuda")


class GatedStackFn(torch.autograd.Function):
    """skip = stack(x, t_bias, cond; wd, wc, wo, b, bc, bo), differentiable in
    every tensor argument. With `need_dcond=False` the conditioner gets no
    gradient and none is computed: only sound when `cond` carries none (the
    mel front end has no parameters)."""

    @staticmethod
    def forward(ctx, dilations, impl, need_dcond, x, t_bias, cond, wd, wc, wo, b, bc, bo):
        if impl not in IMPLS:
            raise ValueError(f"impl {impl!r}; choices: {IMPLS}")
        w = GatedStackWeights(wd=wd, wc=wc, wo=wo, b=b, bc=bc, bo=bo, wt=None, bt=None)
        kw = None
        if impl == "plain":
            skip, xs, a = fwd_saves_ref(x, t_bias, cond, w, dilations)
        else:
            kw = kernel_weights(w) if x.is_cuda else None
            skip, xs, a = fwd_saves(x, t_bias, cond, w, dilations, kweights=kw)
        ctx.dilations, ctx.impl, ctx.need_dcond = tuple(dilations), impl, need_dcond
        ctx.kw_meta = None if kw is None else (kw.taps, kw.mp)
        kw_tensors = (None,) * 5 if kw is None else (kw.wcat, kw.b, kw.b_eff, kw.wo, kw.bo)
        ctx.save_for_backward(t_bias, cond, xs, a, wd, wc, wo, b, bc, bo, *kw_tensors)
        return skip

    @staticmethod
    def backward(ctx, cot):
        t_bias, cond, xs, a, wd, wc, wo, b, bc, bo, *kw_tensors = ctx.saved_tensors
        w = GatedStackWeights(wd=wd, wc=wc, wo=wo, b=b, bc=bc, bo=bo, wt=None, bt=None)
        saves = (t_bias, cond, w, xs, a)
        if ctx.impl == "cuda":
            kw = None if ctx.kw_meta is None else KernelWeights(*kw_tensors, *ctx.kw_meta)
            dx, dtb, dcond, dw = bwd(ctx.dilations, saves, cot, ctx.need_dcond, kweights=kw)
        else:
            dx, dtb, dcond, dw = bwd_ref(ctx.dilations, saves, cot, ctx.need_dcond)
        return (None, None, None, dx, dtb, dcond, dw.wd, dw.wc, dw.wo, dw.b, dw.bc, dw.bo)


def gated_stack_trainable(
    x: torch.Tensor,
    t_bias: torch.Tensor,
    cond: Optional[torch.Tensor],
    w: GatedStackWeights,
    dilations: Sequence[int],
    impl: str = "plain",
    need_dcond: bool = True,
) -> torch.Tensor:
    """`gated_stack` under autograd: x (B, T, C) -> skip (B, T, C) f32."""
    return GatedStackFn.apply(tuple(int(d) for d in dilations), impl, need_dcond,
                              x, t_bias, cond, w.wd, w.wc, w.wo, w.b, w.bc, w.bo)
