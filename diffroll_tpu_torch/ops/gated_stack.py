"""The gated dilated-conv residual stack: the denoiser's hot op (counterpart
of `diffroll_tpu/ops/gated_stack.py`).

Layer math (x (B, T, C), t_bias (L, B, C), cond (B, T, M) or None):
    y    = x + t_bias[l]
    a    = sum_j shift(y, (j - k//2) * d_l) @ Wd[l, j] + cond @ Wc[l] + b[l] + bc[l]
    g    = sigmoid(a[..., :C]) * tanh(a[..., C:])
    out  = g @ Wo[l] + bo[l]
    x    = (x + out[..., :C]) / sqrt(2);  skip += out[..., C:]
output = skip / sqrt(L)

`gated_stack` launches the CUDA kernel (csrc/gated_stack.cu: bf16 operands
brought in by TMA, wgmma products, f32 accumulation) for CUDA tensors and
runs `gated_stack_ref`, the plain f32 PyTorch version, for CPU tensors.

The kernel's tile list is laid out here as the kernel walks it
(`stack_tiles`, `tap_frames`, `tile_waves`): a tile is BM frames of one
sequence x one pair of BN-column slices (n, C + n). `ping_pong_walk` deals a
GEMM launch's tiles to its blocks' two consumer warpgroups as the ping-pong
schedule does, and `hidden_epilogues` counts the tiles whose epilogue runs
under the other warpgroup's k loop (`pass_tiles`: a whole pass's).

`kernel_preamble` is what every kernel wrapper (`gated_stack`, `fwd_saves`,
`bwd`, `fused_sample`) checks and prepares before its C entry.
"""

from __future__ import annotations

import ctypes
import math
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import _build

SQRT_HALF = 0.7071067811865476
BK = 64          # the kernel's k tile (one 128-byte swizzle row of bf16): C and the
                 # padded conditioner width must be multiples
COND_PAD = 256   # conditioner lanes, zero-padded (229 is not a multiple of 64)
SMS = 132        # streaming multiprocessors of an H100
BM = 128         # frames per tile (two 64-row wgmma halves)
BN = 64          # columns per half of a tile's column pair
# timing only: 1 launches the gate GEMMs alone, 2 the output GEMMs alone (the result is void)
PARTS = 3


class GatedStackWeights(NamedTuple):
    """Per-layer weights stacked on a leading L axis, f32, in the JAX
    package's layouts.

    wd (L, k, C, 2C) taps (tap j = time offset (j - k//2) * d); wc (L, M, 2C)
    conditioner 1x1 conv with M zero-padded to 256, or None; wo (L, C, 2C);
    b, bc, bo (L, 2C); wt (L, E, C) and bt (L, C) the diffusion projections,
    or None where only the stack reads the weights.
    """

    wd: torch.Tensor
    wc: Optional[torch.Tensor]
    wo: torch.Tensor
    b: torch.Tensor
    bc: Optional[torch.Tensor]
    bo: torch.Tensor
    wt: Optional[torch.Tensor]
    bt: Optional[torch.Tensor]


def stack_weights(net) -> GatedStackWeights:
    """Stack a `DiffRollNet`'s residual layers (reference layouts: Conv1d
    (O, I, K), Linear (O, I)) into the stack's layouts, under autograd:
    `torch.stack`'s backward is one copy per layer and `F.pad`'s drops the
    conditioner's padding rows again, so gradients reach the parameters in
    their own layouts. `wt` and `bt` stay None: the prepared operands
    (`fused_forward.FusedOperands`) fill them in."""
    layers = list(net.residual_layers)

    def stack(fn):
        return torch.stack([fn(l) for l in layers])

    wc = bc = None
    if hasattr(layers[0], "conditioner_projection"):
        wc = stack(lambda l: l.conditioner_projection.weight[:, :, 0].t())
        wc = F.pad(wc, (0, 0, 0, max(COND_PAD - wc.shape[1], 0)))
        bc = stack(lambda l: l.conditioner_projection.bias)
    return GatedStackWeights(
        wd=stack(lambda l: l.dilated_conv.weight.permute(2, 1, 0)), wc=wc,
        wo=stack(lambda l: l.output_projection.weight[:, :, 0].t()),
        b=stack(lambda l: l.dilated_conv.bias), bc=bc,
        bo=stack(lambda l: l.output_projection.bias), wt=None, bt=None)


def pad_cond(cond: torch.Tensor, width: int) -> torch.Tensor:
    return F.pad(cond, (0, max(width - cond.shape[-1], 0)))


def _shift(y: torch.Tensor, off: int) -> torch.Tensor:
    """y[:, t + off] with zeros outside [0, T)."""
    if off == 0:
        return y
    t = y.shape[1]
    if abs(off) >= t:
        return torch.zeros_like(y)
    if off > 0:
        return F.pad(y[:, off:], (0, 0, 0, off))
    return F.pad(y[:, :off], (0, 0, -off, 0))


def gated_stack_ref(
    x: torch.Tensor,
    t_bias: torch.Tensor,
    cond: Optional[torch.Tensor],
    w: GatedStackWeights,
    dilations: Sequence[int],
) -> torch.Tensor:
    """The plain f32 version (transcription of `gated_stack_xla`)."""
    n_layers, k = w.wd.shape[0], w.wd.shape[1]
    ctr = k // 2
    c = x.shape[-1]
    x = x.float()
    skip_sum = torch.zeros_like(x)
    cond_terms = None
    if cond is not None:
        cond_terms = torch.einsum("btm,lmc->lbtc",
                                  pad_cond(cond.float(), w.wc.shape[1]), w.wc)
    for i in range(n_layers):
        d = int(dilations[i])
        y = x + t_bias[i][:, None, :]
        acc = w.b[i] + sum(_shift(y, (j - ctr) * d) @ w.wd[i, j] for j in range(k))
        if cond_terms is not None:
            acc = acc + cond_terms[i] + w.bc[i]
        g = torch.sigmoid(acc[..., :c]) * torch.tanh(acc[..., c:])
        out = g @ w.wo[i] + w.bo[i]
        x = (x + out[..., :c]) * SQRT_HALF
        skip_sum = skip_sum + out[..., c:]
    return skip_sum / math.sqrt(n_layers)


class KernelWeights(NamedTuple):
    """The kernel's operands, prepared once per model on the device.

    wcat (L, k*C + M, 2C) bf16: each layer's taps, then its padded
    conditioner rows (M = 0 for an unconditional net); b (L, 2C) f32 the
    conv bias alone; b_eff (L, 2C) f32 = b + bc; wo (L, C, 2C) bf16;
    bo (L, 2C) f32.
    """

    wcat: torch.Tensor
    b: torch.Tensor
    b_eff: torch.Tensor
    wo: torch.Tensor
    bo: torch.Tensor
    taps: int
    mp: int


def kernel_weights(w: GatedStackWeights) -> KernelWeights:
    n_layers, taps, c, two_c = w.wd.shape
    parts = [w.wd.reshape(n_layers, taps * c, two_c)]
    if w.wc is not None:
        parts.append(w.wc)
    b = w.b.float().contiguous()
    return KernelWeights(
        wcat=torch.cat(parts, dim=1).to(torch.bfloat16).contiguous(),
        b=b, b_eff=(b + w.bc).contiguous() if w.bc is not None else b,
        wo=w.wo.to(torch.bfloat16).contiguous(), bo=w.bo.float().contiguous(),
        taps=taps, mp=0 if w.wc is None else w.wc.shape[1])


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape, device) -> int:
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(f"{name}: expected contiguous {dtype} {tuple(shape)} on "
                         f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}"
                         f"{'' if t.is_contiguous() else ' (non-contiguous)'}")
    return t.data_ptr()


def check_kernel_shapes(kw: KernelWeights, c: int, n_layers: int, device) -> None:
    """Raise unless the kernel takes these weights as they are."""
    if c % BK or kw.mp % BK:
        raise ValueError(f"the CUDA stack needs C % {BK} == 0 and a conditioner "
                         f"width padded to a multiple of {BK} (C={c}, M={kw.mp})")
    two_c = 2 * c
    _check(kw.wcat, "wcat", torch.bfloat16, (n_layers, kw.taps * c + kw.mp, two_c), device)
    _check(kw.wo, "wo", torch.bfloat16, (n_layers, c, two_c), device)
    for name in ("b", "b_eff", "bo"):
        _check(getattr(kw, name), name, torch.float32, (n_layers, two_c), device)


def stack_tiles(seqs: int, t_len: int) -> List[Tuple[int, int]]:
    """The row tiles of one pass, in the kernel's order: (sequence, first
    frame). A tile never crosses a sequence; the last one of a sequence may
    hold fewer than BM frames."""
    return [(b, t0) for b in range(seqs) for t0 in range(0, t_len, BM)]


def tap_frames(t0: int, tap: int, taps: int, dilation: int) -> range:
    """The frames a tile's A box covers for tap `tap`: BM frames from
    t0 + (tap - taps // 2) * dilation. Those outside [0, T) of the sequence
    are zero-filled by the copy."""
    first = t0 + (tap - taps // 2) * dilation
    return range(first, first + BM)


def tile_waves(seqs: int, t_len: int, c: int) -> Tuple[int, int]:
    """(tiles, waves): the output tiles of one GEMM launch, and the tiles the
    busiest SM computes when they are dealt evenly over the card's SMs."""
    tiles = len(stack_tiles(seqs, t_len)) * (c // BN)
    return tiles, -(-tiles // SMS)


def ping_pong_walk(ntiles: int, grid: int) -> List[List[Tuple[int, int, int]]]:
    """The ping-pong schedule's walk of one GEMM launch of `ntiles` tiles on
    `grid` blocks: for each block, in the order the tensor cores take them,
    (tile, consumer warpgroup, ring position of its first k tile in units of
    a tile's k tiles). Block b's tiles are b, b + grid, ...; its j-th goes to
    warpgroup j % 2 (csrc/gemm_sm90.cuh, PingPongGemm)."""
    return [[(tile, j % 2, j) for j, tile in enumerate(range(b, ntiles, grid))]
            for b in range(grid)]


def hidden_epilogues(ntiles: int, grid: int) -> int:
    """Tiles of one GEMM launch whose epilogue runs under the other consumer
    warpgroup's k loop: every tile of a block's walk but its last."""
    return ntiles - min(ntiles, grid)


def pass_tiles(seqs: int, t_len: int, c: int, n_layers: int,
               sms: int = SMS) -> Tuple[int, int]:
    """(tiles, hidden epilogues) of one stack pass, 2L GEMM launches on
    min(tiles, sms) persistent blocks."""
    tiles, _ = tile_waves(seqs, t_len, c)
    return 2 * n_layers * tiles, 2 * n_layers * hidden_epilogues(tiles, min(tiles, sms))


def kernel_preamble(kw: Optional[KernelWeights], shape: Sequence[int], device,
                    dilations: Sequence[int], t_bias: torch.Tensor, tb_shape: Sequence[int],
                    cond: Optional[torch.Tensor]):
    """What every kernel wrapper checks and prepares before its C entry, for
    a stack over `shape` = (S sequences, T frames, C channels) on `device`:
    `kw` against C, its layer count and the device; one dilation a layer;
    t_bias as f32 at `tb_shape`; the conditioner (S, T, M) zero-padded to
    `kw.mp` lanes in bf16, refused where the weights have no conditioner
    rows. Returns (t_bias, conditioner or None, the dilations as a ctypes
    int array)."""
    if kw is None:
        raise ValueError("the CUDA kernels take `kweights` (kernel_weights(w), the "
                         "stack weights' bf16 operands)")
    seqs, t_len, c = shape
    n_layers = kw.wo.shape[0]
    check_kernel_shapes(kw, c, n_layers, device)
    if len(dilations) != n_layers:
        raise ValueError(f"{len(dilations)} dilations for {n_layers} layers")
    tb = t_bias.float().contiguous()
    _check(tb, "t_bias", torch.float32, tb_shape, device)
    cond16 = None
    if cond is not None:
        if kw.mp == 0:
            raise ValueError("cond given to a stack without conditioner weights")
        cond16 = pad_cond(cond, kw.mp).to(torch.bfloat16).contiguous()
        _check(cond16, "cond", torch.bfloat16, (seqs, t_len, kw.mp), device)
    return tb, cond16, (ctypes.c_int * n_layers)(*[int(d) for d in dilations])


def gated_stack(
    x: torch.Tensor,
    t_bias: torch.Tensor,
    cond: Optional[torch.Tensor],
    w: GatedStackWeights,
    dilations: Sequence[int],
    kweights: Optional[KernelWeights] = None,
) -> torch.Tensor:
    """x (B, T, C) f32 -> skip output (B, T, C) f32.

    CPU tensors run `gated_stack_ref` on `w`. CUDA tensors launch K1 on
    `kweights`, the bf16 operands prepared once by `kernel_weights(w)`, or
    raise.
    """
    if not x.is_cuda:
        return gated_stack_ref(x, t_bias, cond, w, dilations)
    kw = kweights
    bsz, t_len, c = x.shape
    tb, cond16, dil = kernel_preamble(kw, x.shape, x.device, dilations, t_bias,
                                      (len(dilations), bsz, c), cond)
    m = bsz * t_len
    x16 = x.to(torch.bfloat16, copy=True).contiguous().view(m, c)  # mutated
    skip = torch.empty(bsz, t_len, c, device=x.device, dtype=torch.float32)
    scratch = torch.empty(2, m, c, device=x.device, dtype=torch.bfloat16)  # gated, taps' input
    colbias = kw.b if cond16 is None else kw.b_eff
    _build.check(_build.library().drk_gated_stack(
        x16.data_ptr(), skip.data_ptr(), scratch[0].data_ptr(), scratch[1].data_ptr(),
        tb.data_ptr(), bsz * c, c, None if cond16 is None else cond16.data_ptr(), kw.mp,
        kw.wcat.data_ptr(), kw.wcat.shape[1], colbias.data_ptr(), None, kw.wo.data_ptr(),
        kw.bo.data_ptr(), ctypes.addressof(dil), kw.wo.shape[0], m, t_len, c, kw.taps, PARTS,
        torch.cuda.current_stream().cuda_stream), "gated_stack")
    gated_stack.launches += 1
    return skip


gated_stack.launches = 0  # forward stack passes launched: K1's, and K2's steps
