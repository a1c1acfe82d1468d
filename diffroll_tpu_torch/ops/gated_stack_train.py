"""The training kernels of the gated stack (counterpart of
`diffroll_tpu/ops/gated_stack_train.py`): the forward that also saves what
the backward needs, and the backward, each beside its plain version.

  * `fwd_saves` replaces `gated_stack_fwd_pallas`. On CUDA tensors it launches
    K1's kernels with the saves switched on (csrc/gated_stack_train.cu,
    `drk_gated_stack_fwd_saves`): skip (B, T, C) f32, xs (L, B, T, C) bf16 (each
    layer's input x, before its time bias) and a (L, B, T, 2C) bf16 (the
    pre-gate activation).
  * `bwd` replaces `gated_stack_bwd_pallas`: one reverse sweep over the
    layers from the saves (`drk_gated_stack_bwd`), giving dx, dt_bias, dcond
    where asked, and the gradient of every stacked weight, all f32.

What bounds them on this card: operations. At B=16 the forward is ~0.73
TFLOP and the backward ~1.37 TFLOP of bf16 products against a few hundred MB
of saves and operands, so every product runs on the tensor cores (bf16
operands brought in by TMA, wgmma, f32 sums in registers) and the gate, its
derivative, the residual updates and the bias sums ride in GEMM epilogues.
The backward multiplies by the forward's own `kweights` as they lie: its
kernels read them transposed through their descriptors. The weight gradients
contract over the B*T rows: where that fills the card the rows are split by
whole sequences (`wgrad_plan`) and the f32 partials are added in a fixed
order by a second pass, so the result is the same bits every run.

On CPU tensors both wrappers run the plain versions `fwd_saves_ref` and
`bwd_ref` (transcriptions of `_fwd_saves_xla` and `_bwd_xla`); on CUDA
tensors they launch the kernels or raise.
"""

from __future__ import annotations

import ctypes
import math
from typing import List, Optional, Sequence, Tuple

import torch

from . import _build
from .gated_stack import (
    SMS, SQRT_HALF, GatedStackWeights, KernelWeights, _check, _shift, kernel_preamble, pad_cond)

BWD_TILE = 128  # the backward's tiles are 128 x 128: C and the padded conditioner width
WGRAD_BOX = 64  # frames per k tile of a weight-gradient product
WGRAD_ITEM_KT = 8  # a weight-gradient work item's start-up and epilogue, in k tiles
# timing only: bit 0 launches dg alone, 1 dWo, 2 dW, 3 dy, 4 the rest (the result is void)
PARTS = 31


def _wide(t: torch.Tensor) -> torch.Tensor:
    """bf16 saves to f32; f32 and f64 stay as they are."""
    return t if t.dtype in (torch.float32, torch.float64) else t.float()


def fwd_saves_ref(x, t_bias, cond, w: GatedStackWeights, dilations: Sequence[int]):
    """`gated_stack_ref` that also returns the saves: (skip, xs (L, B, T, C),
    a (L, B, T, 2C)), in x's dtype."""
    n_layers, k = w.wd.shape[0], w.wd.shape[1]
    ctr = k // 2
    c = x.shape[-1]
    x = _wide(x)
    skip_sum = torch.zeros_like(x)
    cond_terms = None
    if cond is not None:
        cond_terms = torch.einsum("btm,lmc->lbtc", pad_cond(_wide(cond), w.wc.shape[1]), w.wc)
    xs, a_all = [], []
    for i in range(n_layers):
        d = int(dilations[i])
        xs.append(x)
        y = x + t_bias[i][:, None, :]
        acc = w.b[i] + sum(_shift(y, (j - ctr) * d) @ w.wd[i, j] for j in range(k))
        if cond_terms is not None:
            acc = acc + cond_terms[i] + w.bc[i]
        a_all.append(acc)
        g = torch.sigmoid(acc[..., :c]) * torch.tanh(acc[..., c:])
        out = g @ w.wo[i] + w.bo[i]
        x = (x + out[..., :c]) * SQRT_HALF
        skip_sum = skip_sum + out[..., c:]
    return skip_sum / math.sqrt(n_layers), torch.stack(xs), torch.stack(a_all)


def bwd_ref(dilations: Sequence[int], saves, cot, need_dcond: bool = True):
    """The plain backward from the saves `(t_bias, cond, w, xs, a)` and the
    cotangent of the skip output. Returns (dx, dt_bias, dcond or None,
    GatedStackWeights of gradients; wt and bt are None)."""
    t_bias, cond, w, xs, a_all = saves
    n_layers, k, c, _ = w.wd.shape
    ctr = k // 2
    cot = _wide(cot)
    dskip = cot / math.sqrt(n_layers)
    dx = torch.zeros_like(cot)
    dtb, dwd, dwo, db, dbo, dwc = [], [], [], [], [], []
    cond_p = pad_cond(_wide(cond), w.wc.shape[1]) if cond is not None else None
    dcond_p = torch.zeros_like(cond_p) if cond is not None and need_dcond else None

    for i in reversed(range(n_layers)):
        d = int(dilations[i])
        a = _wide(a_all[i])
        s1 = torch.sigmoid(a[..., :c])
        th = torch.tanh(a[..., c:])
        g = s1 * th
        dout = torch.cat([dx * SQRT_HALF, dskip], dim=-1)
        dwo.append(torch.einsum("btc,btd->cd", g, dout))
        dbo.append(dout.sum((0, 1)))
        dg = dout @ w.wo[i].t()
        da = torch.cat([dg * th * s1 * (1.0 - s1), dg * s1 * (1.0 - th * th)], dim=-1)
        db.append(da.sum((0, 1)))
        if cond is not None:
            dwc.append(torch.einsum("btm,btd->md", cond_p, da))
            if need_dcond:
                dcond_p = dcond_p + da @ w.wc[i].t()
        y = _wide(xs[i]) + t_bias[i][:, None, :]
        dy = torch.zeros_like(dx)
        dwd_i = []
        for j in range(k):
            off = (j - ctr) * d
            dwd_i.append(torch.einsum("btc,btd->cd", _shift(y, off), da))
            dy = dy + _shift(da @ w.wd[i, j].t(), -off)
        dwd.append(torch.stack(dwd_i))
        dtb.append(dy.sum(1))
        dx = dx * SQRT_HALF + dy

    def stack_rev(lst):
        return torch.stack(lst[::-1])

    db_s = stack_rev(db)
    conditional = cond is not None
    dw = GatedStackWeights(
        wd=stack_rev(dwd), wc=stack_rev(dwc) if conditional else None, wo=stack_rev(dwo),
        b=db_s, bc=db_s if conditional else None, bo=stack_rev(dbo), wt=None, bt=None)
    dcond = dcond_p[..., : cond.shape[-1]] if dcond_p is not None else None
    return dx, stack_rev(dtb), dcond, dw


def fwd_saves(x, t_bias, cond, w: GatedStackWeights, dilations: Sequence[int],
              kweights: Optional[KernelWeights] = None):
    """x (B, T, C) -> (skip (B, T, C) f32, xs (L, B, T, C), a (L, B, T, 2C)).

    CPU tensors run `fwd_saves_ref` on `w` (f32 saves). CUDA tensors launch
    the kernel on `kweights` (bf16 saves) or raise.
    """
    if not x.is_cuda:
        return fwd_saves_ref(x, t_bias, cond, w, dilations)
    kw = kweights
    bsz, t_len, c = x.shape
    tb, cond16, dil = kernel_preamble(kw, x.shape, x.device, dilations, t_bias,
                                      (len(dilations), bsz, c), cond)
    n_layers = kw.wo.shape[0]
    m = bsz * t_len
    dev = x.device
    xs = torch.empty(n_layers, m, c, device=dev, dtype=torch.bfloat16)
    xs[0].copy_(x.reshape(m, c))
    a = torch.empty(n_layers, m, 2 * c, device=dev, dtype=torch.bfloat16)
    skip = torch.empty(bsz, t_len, c, device=dev, dtype=torch.float32)
    scratch = torch.empty(3, m, c, device=dev, dtype=torch.bfloat16)
    colbias = kw.b_eff if cond is not None else kw.b
    rc = _build.library().drk_gated_stack_fwd_saves(
        scratch[0].data_ptr(), skip.data_ptr(), scratch[1].data_ptr(), scratch[2].data_ptr(),
        tb.data_ptr(), bsz * c, c, None if cond16 is None else cond16.data_ptr(), kw.mp,
        kw.wcat.data_ptr(), kw.wcat.shape[1], colbias.data_ptr(), kw.wo.data_ptr(),
        kw.bo.data_ptr(), ctypes.addressof(dil), n_layers, m, t_len, c, kw.taps,
        xs.data_ptr(), a.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "gated_stack_fwd_saves")
    fwd_saves.launches += 1
    return skip, xs.view(n_layers, bsz, t_len, c), a.view(n_layers, bsz, t_len, 2 * c)


fwd_saves.launches = 0  # K3 passes launched


def wgrad_plan(seqs: int, t_len: int, rows: int, cols: int) -> Tuple[int, int, int, int]:
    """How a weight-gradient product (rows x cols, contracted over seqs x t_len
    frames) is split over the card: (splits, sequences per split, work items,
    waves). A work item is one 128 x 128 output tile of one split; its k loop
    walks the 64-frame boxes of the split's whole sequences, and the items are
    dealt over the card's SMs, one persistent block each. The split is the
    one with the shortest busiest block, an item's start-up and epilogue
    counted as `WGRAD_ITEM_KT` k tiles; of equals, the fewest splits (fewer
    f32 partials to write and add)."""
    tiles = (rows // BWD_TILE) * (cols // BWD_TILE)
    kt_per_seq = -(-t_len // WGRAD_BOX)
    best = None
    for per_split in range(seqs, 0, -1):
        splits = -(-seqs // per_split)
        if -(-seqs // splits) != per_split:
            continue  # the kernel deals ceil(seqs / splits) sequences to a split
        items = tiles * splits
        waves = -(-items // SMS)
        cost = waves * (per_split * kt_per_seq + WGRAD_ITEM_KT)
        if best is None or cost < best[0]:
            best = (cost, splits, per_split, items, waves)
    return best[1:]


def wgrad_boxes(seqs: int, t_len: int, splits: int) -> List[List[Tuple[int, int]]]:
    """The k loop of a weight-gradient work item, per split, in the kernel's
    order: (sequence, first frame) of each 64-frame box. A split holds whole
    sequences; a sequence's last box may reach past T (zero-filled)."""
    per_split = -(-seqs // splits)
    return [[(b, f0) for b in range(z * per_split, min(seqs, (z + 1) * per_split))
             for f0 in range(0, t_len, WGRAD_BOX)] for z in range(splits)]


def wgrad_tap_frames(f0: int, tap: int, taps: int, dilation: int) -> range:
    """The frames of y that tap `tap`'s box pairs with the da16 frames
    f0 .. f0 + 63: the forward's shift. Frames outside [0, T) are zero-filled
    in either operand's box, so every product outside the sequence has a zero
    factor."""
    first = f0 + (tap - taps // 2) * dilation
    return range(first, first + WGRAD_BOX)


def dy_tap_frames(t0: int, tap: int, taps: int, dilation: int) -> range:
    """The frames of da16 a dy tile's A box covers for tap `tap`: the
    forward's shift with the dilation negated."""
    first = t0 - (tap - taps // 2) * dilation
    return range(first, first + BWD_TILE)


def bwd(dilations: Sequence[int], saves, cot, need_dcond: bool = True,
        kweights: Optional[KernelWeights] = None):
    """The backward from `saves = (t_bias, cond, w, xs, a)`; same returns as
    `bwd_ref`. CPU tensors run `bwd_ref` on `w`. CUDA tensors launch the
    kernel on `kweights`, the operands the forward used, as they lie (the
    kernel reads them transposed through its descriptors), or raise."""
    t_bias, cond, w, xs, a = saves
    if not cot.is_cuda:
        return bwd_ref(dilations, saves, cot, need_dcond)
    kw = kweights
    bsz, t_len, c = cot.shape
    tb, cond16, dil = kernel_preamble(kw, cot.shape, cot.device, dilations, t_bias,
                                      (len(dilations), bsz, c), cond)
    n_layers, taps = kw.wo.shape[0], kw.taps
    m, two_c, kc = bsz * t_len, 2 * c, kw.taps * c
    dev = cot.device
    if c % BWD_TILE or kw.mp % BWD_TILE:
        raise ValueError(f"the CUDA backward needs C and the padded conditioner width to be "
                         f"multiples of {BWD_TILE} (C={c}, M={kw.mp})")
    _check(xs, "xs", torch.bfloat16, (n_layers, bsz, t_len, c), dev)
    _check(a, "a", torch.bfloat16, (n_layers, bsz, t_len, two_c), dev)
    cot32 = cot.float().contiguous()
    mp = kw.mp if cond16 is not None else 0
    want_dcond = need_dcond and cond16 is not None

    f32 = dict(device=dev, dtype=torch.float32)
    b16 = dict(device=dev, dtype=torch.bfloat16)
    dx = torch.zeros(bsz, t_len, c, **f32)
    dwo = torch.empty(n_layers, c, two_c, **f32)
    dwcat = torch.empty(n_layers, kc + mp, two_c, **f32)
    db = torch.empty(n_layers, two_c, **f32)
    dcond = torch.zeros(bsz, t_len, mp, **f32) if want_dcond else None  # summed over layers
    ssum = torch.zeros(n_layers + 1, bsz, c, **f32)  # S_l; S_L = 0
    scot = torch.empty(bsz, c, **f32)
    splits_wo = wgrad_plan(bsz, t_len, c, two_c)[0]
    splits_wcat = wgrad_plan(bsz, t_len, kc + mp, two_c)[0]
    part_rows = max(splits_wo * c if splits_wo > 1 else 0,
                    splits_wcat * (kc + mp) if splits_wcat > 1 else 0)
    part = torch.empty(part_rows, two_c, **f32) if part_rows else None
    dout16 = torch.empty(m, two_c, **b16)
    gy16 = torch.empty(2, m, c, **b16)
    da16 = torch.empty(m, two_c, **b16)
    warp_rows = bsz * -(-t_len // BWD_TILE) * 8  # column sums per consumer warp of a row tile
    db_part = torch.empty(n_layers, warp_rows, two_c, **f32)
    ss_part = torch.empty(n_layers, warp_rows, c, **f32)

    rc = _build.library().drk_gated_stack_bwd(
        xs.data_ptr(), a.data_ptr(), None if cond16 is None else cond16.data_ptr(), kw.mp,
        tb.data_ptr(), bsz * c, c, kw.wcat.data_ptr(), kw.wcat.shape[1], kw.wo.data_ptr(),
        cot32.data_ptr(), dx.data_ptr(), dwo.data_ptr(), dwcat.data_ptr(), db.data_ptr(),
        None if dcond is None else dcond.data_ptr(), ssum.data_ptr(), scot.data_ptr(),
        dout16.data_ptr(), gy16[0].data_ptr(), gy16[1].data_ptr(), da16.data_ptr(),
        None if part is None else part.data_ptr(), db_part.data_ptr(), ss_part.data_ptr(),
        ctypes.addressof(dil), n_layers, m, t_len, c, taps, splits_wo, splits_wcat, PARTS,
        torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "gated_stack_bwd")
    bwd.launches += 1

    # dtb_l = sum_T dy_l = S_l - S_{l+1}/sqrt(2); dbo_l = column sums of dout_l
    dtb = ssum[:-1] - SQRT_HALF * ssum[1:]
    dbo = torch.cat([SQRT_HALF * ssum[1:].sum(1),
                     (scot.sum(0) / math.sqrt(n_layers)).expand(n_layers, c)], dim=1)
    conditional = cond16 is not None
    dw = GatedStackWeights(
        wd=dwcat[:, :kc].reshape(n_layers, taps, c, two_c),
        wc=dwcat[:, kc:] if conditional else None, wo=dwo, b=db,
        bc=db if conditional else None, bo=dbo, wt=None, bt=None)
    return dx, dtb, None if dcond is None else dcond[..., : cond.shape[-1]], dw


bwd.launches = 0  # K4 sweeps launched
