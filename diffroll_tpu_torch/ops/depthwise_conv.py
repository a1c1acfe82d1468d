"""Depthwise 7x7 convolution over NCHW f32 on the card (csrc/depthwise_conv.cu),
and the plan that splits each plane into strips over the grid.

`depthwise_conv` is `F.conv2d(x, weight, bias, stride, padding, 1, C)` with a
route: CPU tensors take `F.conv2d` unchanged; CUDA tensors take
`DepthwiseConvFn`, the hand-written forward and backward, on a contiguous
copy of the input where it is not contiguous. A CUDA call the kernels cannot
take (not f32, a kernel other than 7x7 with stride 1 and padding 3, 2**31
values or more) raises: nothing on the card falls back to PyTorch's kernels.
`depthwise_conv.launches` counts the forward passes on the kernels.

Why kernels of our own: the forward reads x and writes y, the backward reads
dy and x and writes dx, at 49 multiply-adds a value a pass, so bytes bound
both; PyTorch's forward and input gradient load each output's 49 taps
through the cache, and its weight gradient reduces each of the C x 49 taps
in its own block, reading x and dy 49 times over. Here a block stages one plane's strip of `th` rows (and a tile
of up to 128 columns) with its halo in shared memory once, each thread
computes 8 rows x 4 columns from it, and the backward's weight and bias sums
are split over the same blocks, one partial of 50 a block, merged in an order
the shape fixes, so every run gives the same bits
(tests/test_torch_depthwise_conv.py mirrors the order in numpy). The forward
saves x and the weight, as PyTorch's convolution does.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from . import _build
from .gated_stack import SMS

K = 7                  # taps a side
PAD = K // 2           # 'SAME'
RH, COLS = 8, 4        # a thread's output rows and columns
THREADS = 256          # a block's most threads
MAX_GROUPS = 32        # column groups a tile: 128 columns
PART = K * K + 1       # a block's partial: the 49 taps' sums, then dy's
RESIDENT = 2           # blocks an SM holds at once (__launch_bounds__)
TARGET_BLOCKS = 2 * SMS * RESIDENT   # two full waves of the card


class Plan(NamedTuple):
    """A launch's geometry: each plane's output rows in `strips` strips of
    `th` (a multiple of RH), its columns in `tiles` tiles of `ncg` groups of
    4; a block (strip, tile) runs ncg * th / RH threads' units."""

    th: int
    strips: int
    ncg: int
    tiles: int

    @property
    def units(self) -> int:
        return self.ncg * (self.th // RH)

    @property
    def threads(self) -> int:
        return -(-self.units // 32) * 32


def strip_plan(planes: int, h: int, w: int) -> Plan:
    """The strips and tiles of `planes` planes of h x w. Column tiles of at
    most MAX_GROUPS groups of 4, as even as can be; a strip as tall as a
    block of THREADS takes, unless planes x strips would then fall short of
    two waves of the card, when the strips shrink (to RH rows at least)."""
    groups = -(-w // COLS)
    tiles = -(-groups // MAX_GROUPS)
    ncg = -(-groups // tiles)
    runs = -(-h // RH)                      # RH-row runs a plane
    per_block = max(1, THREADS // ncg)      # runs a block of THREADS takes
    strips = max(-(-runs // per_block), -(-TARGET_BLOCKS // (planes * tiles)))
    th = max(1, runs // strips) * RH
    return Plan(th, -(-h // th), ncg, tiles)


# ------------------------------------------------------------ the kernels

class DepthwiseConvFn(torch.autograd.Function):
    """A depthwise 7x7 'SAME' conv on contiguous f32 CUDA tensors through the
    kernels: x (N, C, H, W), weight (C, 1, 7, 7), bias (C) or None."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        n, c, h, w = x.shape
        plan = strip_plan(n * c, h, w)
        y = torch.empty_like(x)
        rc = _build.library().drk_dwconv_fwd(
            x.data_ptr(), weight.data_ptr(), 0 if bias is None else bias.data_ptr(),
            y.data_ptr(), n, c, h, w, *plan, torch.cuda.current_stream().cuda_stream)
        _build.check(rc, "dwconv_fwd")
        ctx.has_bias = bias is not None
        ctx.save_for_backward(x, weight)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        dy = dy.contiguous()
        n, c, h, w = x.shape
        plan = strip_plan(n * c, h, w)
        f32 = dict(device=x.device, dtype=torch.float32)
        dx = torch.empty_like(x)
        dweight = torch.empty_like(weight)
        dbias = torch.empty(c, **f32)
        part = torch.empty(n * c * plan.strips * plan.tiles, PART, **f32)
        rc = _build.library().drk_dwconv_bwd(
            dy.data_ptr(), x.data_ptr(), weight.data_ptr(), dx.data_ptr(), part.data_ptr(),
            dweight.data_ptr(), dbias.data_ptr(), n, c, h, w, *plan,
            torch.cuda.current_stream().cuda_stream)
        _build.check(rc, "dwconv_bwd")
        need = ctx.needs_input_grad
        return (dx if need[0] else None, dweight if need[1] else None,
                dbias if ctx.has_bias and need[2] else None)


Pair = Union[int, Sequence[int]]


def _pair(v: Pair):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def check(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
          stride: Pair = 1, padding: Pair = PAD, dilation: Pair = 1) -> None:
    """Raise unless the kernels can take the call: x f32 (N, C, H, W) with
    values, fewer than 2**31 (the C entries take 32-bit sizes); weight f32
    (C, 1, 7, 7) and bias f32 (C) or None on x's device; stride 1, padding
    3, dilation 1."""
    if x.dtype != torch.float32 or x.dim() != 4 or not 0 < x.numel() < 2 ** 31:
        raise ValueError(f"a depthwise conv on the card takes f32 (N, C, H, W) inputs of "
                         f"fewer than 2**31 values; got {x.dtype} {tuple(x.shape)}")
    c = x.shape[1]
    if weight.dtype != torch.float32 or tuple(weight.shape) != (c, 1, K, K) \
            or weight.device != x.device:
        raise ValueError(f"a depthwise conv on the card takes an f32 ({c}, 1, {K}, {K}) "
                         f"weight on {x.device}; got {weight.dtype} {tuple(weight.shape)} "
                         f"on {weight.device}")
    if bias is not None and (bias.dtype != torch.float32 or tuple(bias.shape) != (c,)
                             or bias.device != x.device):
        raise ValueError(f"a depthwise conv on the card takes an f32 bias of {c} on {x.device}")
    if _pair(stride) != (1, 1) or _pair(padding) != (PAD, PAD) or _pair(dilation) != (1, 1):
        raise ValueError(f"a depthwise conv on the card is 'SAME' with stride 1: padding "
                         f"{PAD}, dilation 1; got stride {stride}, padding {padding}, "
                         f"dilation {dilation}")


def depthwise_conv(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
                   stride: Pair = 1, padding: Pair = PAD, dilation: Pair = 1) -> torch.Tensor:
    """F.conv2d(x, weight, bias, stride, padding, dilation, groups=C): on the
    kernels for CUDA tensors, `F.conv2d` itself for CPU ones."""
    if not x.is_cuda:
        return F.conv2d(x, weight, bias, stride, padding, dilation, x.shape[1])
    check(x, weight, bias, stride, padding, dilation)
    depthwise_conv.launches += 1
    return DepthwiseConvFn.apply(x.contiguous(), weight.contiguous(),
                                 None if bias is None else bias.contiguous())


depthwise_conv.launches = 0   # forward passes on the kernels
