"""GroupNorm over NCHW f32 on the card (csrc/group_norm.cu), and the plan
that splits its reductions over the grid.

`group_norm` is `F.group_norm` with a route: CPU tensors take
`F.group_norm` unchanged; CUDA tensors take `GroupNormFn`, the hand-written
forward and backward, on a contiguous copy of the input where it is not
contiguous. A CUDA call the kernels cannot take (not f32, no affine
parameters, 2**31 values or more) raises: nothing on the card falls back
to PyTorch's kernels. `group_norm.launches` counts the forward passes on the
kernels.

Why a kernel of our own: the U-Nets' norms mostly have one group, and
PyTorch reduces each (sample, group) in one thread block, so a batch of 16
runs 16 blocks on the card's 132 SMs, each a serial pass over up to 3.2 M
values. Here a reduction of R rows of L values runs R x `splits` blocks
(`split_plan`): each block reduces a chunk of one row to a partial, and the
partials are merged in an order the shape fixes, so every run gives the same
bits. The forward's statistics are Welford's per thread, merged by Chan's
formula through a shuffle tree a warp and a tree over the block's warps,
then over the row's partials (tests/test_torch_group_norm.py mirrors them in
numpy). The backward's per-(sample, channel) sums of dy and dy x are split
over the planes the same way; dx, dgamma and dbeta follow PyTorch's
`native_group_norm_backward`. Everything stays f32; the forward saves x,
mean and rstd, as PyTorch's does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from . import _build
from .gated_stack import SMS

THREADS = 256          # a block: 8 warps
VEC = 4                # values a load (16 bytes) and a Welford group
RESIDENT = 8           # blocks of THREADS an SM holds at once (2,048 threads)
TARGET_BLOCKS = 2 * SMS * RESIDENT   # two full waves of the card
MIN_CHUNK = THREADS * VEC // 2       # a block's least chunk: a group for half its threads


def split_plan(rows: int, length: int) -> Tuple[int, int]:
    """(splits, chunk): blocks a row and values a block, for a reduction (or
    a pass) over `rows` rows of `length` values. Rows that fill two waves of
    the card alone take one block each; otherwise each row is split into
    enough chunks for two waves, but no chunk shorter than `MIN_CHUNK`. A
    chunk is a multiple of 4 values; the last of a row may be shorter."""
    if rows >= TARGET_BLOCKS:
        splits = 1
    else:
        splits = max(1, min(-(-TARGET_BLOCKS // rows), length // MIN_CHUNK))
    chunk = -(-length // splits)
    chunk = -(-chunk // VEC) * VEC
    return -(-length // chunk), chunk


# ------------------------------------------------------------ the kernels

def _launch_shapes(x: torch.Tensor, groups: int):
    n, c = x.shape[:2]
    hw = x[0, 0].numel()
    return n, c, hw, split_plan(n * groups, (c // groups) * hw), split_plan(n * c, hw)


class GroupNormFn(torch.autograd.Function):
    """F.group_norm on contiguous f32 CUDA tensors through the kernels."""

    @staticmethod
    def forward(ctx, x, weight, bias, groups: int, eps: float):
        n, c, hw, (splits, chunk), (psplits, pchunk) = _launch_shapes(x, groups)
        f32 = dict(device=x.device, dtype=torch.float32)
        y = torch.empty_like(x)
        mean = torch.empty(n * groups, **f32)
        rstd = torch.empty(n * groups, **f32)
        part = torch.empty(n * groups * splits, 4, **f32)
        rc = _build.library().drk_group_norm_fwd(
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(), mean.data_ptr(),
            rstd.data_ptr(), part.data_ptr(), n, c, hw, groups, eps, splits, chunk, psplits,
            pchunk, torch.cuda.current_stream().cuda_stream)
        _build.check(rc, "group_norm_fwd")
        ctx.groups = groups
        ctx.save_for_backward(x, weight, mean, rstd)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, weight, mean, rstd = ctx.saved_tensors
        groups = ctx.groups
        dy = dy.contiguous()
        n, c, hw, _, (psplits, pchunk) = _launch_shapes(x, groups)
        f32 = dict(device=x.device, dtype=torch.float32)
        dx = torch.empty_like(x)
        dweight = torch.empty(c, **f32)
        dbias = torch.empty(c, **f32)
        part = torch.empty(n * c * psplits, 2, **f32)
        dsdb = torch.empty(n * c, 2, **f32)
        c23 = torch.empty(n * groups, 2, **f32)
        rc = _build.library().drk_group_norm_bwd(
            dy.data_ptr(), x.data_ptr(), weight.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
            dx.data_ptr(), dweight.data_ptr(), dbias.data_ptr(), part.data_ptr(),
            dsdb.data_ptr(), c23.data_ptr(), n, c, hw, groups, psplits, pchunk,
            torch.cuda.current_stream().cuda_stream)
        _build.check(rc, "group_norm_bwd")
        need = ctx.needs_input_grad
        return (dx if need[0] else None, dweight if need[1] else None,
                dbias if need[2] else None, None, None)


def check(x: torch.Tensor, weight: Optional[torch.Tensor], bias: Optional[torch.Tensor],
          groups: int) -> None:
    """Raise unless the kernels can take the call: x f32 (N, C, ...) with
    values, fewer than 2**31 (the C entries take 32-bit sizes), C a multiple
    of `groups`, f32 weight and bias of C on x's device."""
    if x.dtype != torch.float32 or x.dim() < 3 or not 0 < x.numel() < 2 ** 31:
        raise ValueError(f"GroupNorm on the card takes f32 (N, C, ...) inputs of fewer than "
                         f"2**31 values; got {x.dtype} {tuple(x.shape)}")
    if x.shape[1] % groups:
        raise ValueError(f"{x.shape[1]} channels do not split into {groups} groups")
    if weight is None or bias is None or any(
            p.dtype != torch.float32 or p.shape != (x.shape[1],) or p.device != x.device
            for p in (weight, bias)):
        raise ValueError(f"GroupNorm on the card takes f32 weight and bias of {x.shape[1]} "
                         f"on {x.device}")


def group_norm(x: torch.Tensor, groups: int, weight: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None, eps: float = 1e-5) -> torch.Tensor:
    """F.group_norm(x, groups, weight, bias, eps): on the kernels for CUDA
    tensors, `F.group_norm` itself for CPU ones."""
    if not x.is_cuda:
        return F.group_norm(x, groups, weight, bias, eps)
    check(x, weight, bias, groups)
    group_norm.launches += 1
    return GroupNormFn.apply(x.contiguous(), weight.contiguous(), bias.contiguous(), groups,
                             eps)


group_norm.launches = 0   # forward passes on the kernels
