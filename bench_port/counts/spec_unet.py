"""Operations and bytes of SpecUnet's forward (`diffroll_tpu_torch/nn/unet.py`
`SpecUnetNet`), from its widths, term by term, counted as
`torch.utils.flop_counter.FlopCounterMode` counts them: every convolution
(2 x output positions x taps x input channels a group x output channels; a
transposed one over its input positions), every Linear and every attention
product, a multiply-add two operations; norms, nonlinearities, softmaxes and
sums not counted. One row is one 640-frame window.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

from . import F32, bound_s

HEADS, DIM_HEAD = 4, 32
INNER = HEADS * DIM_HEAD


class UShape(NamedTuple):
    """A SpecUnet configuration's widths as the counts need them."""

    dim: int = 28
    mults: tuple = (1, 2, 4)
    convnext_mult: int = 2
    n_mels: int = 229
    frames: int = 640
    pitches: int = 88


def shape_of(cfg: dict) -> UShape:
    return UShape(cfg["residual_channels"], tuple(cfg["dim_mults"]), cfg["convnext_mult"],
                  cfg["n_mels"], cfg["frames"], cfg["pitches"])


def _conv(positions: int, taps: int, c_in: int, c_out: int) -> float:
    return 2.0 * positions * taps * c_in * c_out


def _levels(s: UShape):
    """Each level's (in, out) widths and its positions (T x 88, halved a level,
    rounded up)."""
    dims = [s.dim // 3 * 2] + [s.dim * m for m in s.mults]
    t, k, out = s.frames, s.pitches, []
    for d_in, d_out in zip(dims[:-1], dims[1:]):
        out.append((d_in, d_out, t * k))
        t, k = -(-t // 2), -(-k // 2)
    return out


def block_flops(s: UShape, d_in: int, spec_in: int, d_out: int, n: int, lift: bool) -> float:
    """One ConvNeXt block over both streams at `n` positions: the depthwise
    7x7s (the spectrogram's a dense 7x7 lift in the up path), the step
    projection, each stream's two 3x3 convs, the 1x1 residual conv."""
    mid = d_out * s.convnext_mult
    spec_mid = d_in if lift else spec_in
    out = _conv(n, 49, 1, d_in)
    out += _conv(n, 49, spec_in, d_in) if lift else _conv(n, 49, 1, spec_in)
    out += 2.0 * 4 * s.dim * d_in
    out += _conv(n, 9, d_in, mid) + _conv(n, 9, mid, d_out)
    out += _conv(n, 9, spec_mid, mid) + _conv(n, 9, mid, d_out)
    if d_in != d_out:
        out += _conv(n, 1, d_in, d_out)
    return out


def block_bytes(s: UShape, d_in: int, spec_in: int, d_out: int, n: int, lift: bool) -> float:
    """Its inputs (x, the spectrogram), outputs (both streams) and weights,
    each once, in f32."""
    mid = d_out * s.convnext_mult
    spec_mid = d_in if lift else spec_in
    weights = (49 * d_in + (49 * spec_in * d_in if lift else 49 * spec_in) + 4 * s.dim * d_in
               + 9 * (d_in + spec_mid) * mid + 2 * 9 * mid * d_out
               + (d_in * d_out if d_in != d_out else 0))
    return F32 * (n * (d_in + spec_in + 2 * d_out) + weights)


def linear_attention_flops(d: int, n: int) -> float:
    """q, k, v (1x1 conv), the k^T v context and its product with q, the
    output 1x1 conv."""
    return (_conv(n, 1, d, 3 * INNER) + 2 * (2.0 * HEADS * n * DIM_HEAD * DIM_HEAD)
            + _conv(n, 1, INNER, d))


def attention_product_flops(n: int) -> float:
    """Full attention's two products over `n` positions: q k^T and the
    weights times v."""
    return 2 * (2.0 * HEADS * n * n * DIM_HEAD)


def attention_flops(d: int, n: int) -> float:
    return _conv(n, 1, d, 3 * INNER) + attention_product_flops(n) + _conv(n, 1, INNER, d)


def attention_bytes(n: int) -> float:
    """q, k, v and the output of the two products, each once, in f32."""
    return F32 * 4 * HEADS * n * DIM_HEAD


def _blocks(s: UShape):
    """Every block as (d_in, spec_in, d_out, positions, lift), in order."""
    levels = _levels(s)
    out = []
    for d_in, d_out, n in levels:
        out += [(d_in, d_in, d_out, n, False), (d_out, d_out, d_out, n, False)]
    width, n_mid = levels[-1][1], levels[-1][2]
    out += [(width, width, width, n_mid, False)] * 2
    for d_in, d_out, n in reversed(levels[1:]):
        out += [(width + 2 * d_out, width, d_in, n, True), (d_in, d_in, d_in, n, False)]
        width = d_in
    out.append((width, width, s.dim, levels[0][2], False))
    return out


def forward_terms(s: UShape, rows: int = 1) -> Dict[str, float]:
    """The forward's operations over `rows` windows, by part: `blocks`,
    `linear_attn`, `attn` (the bottleneck's, 1x1 convs included), `resample`,
    `stem` (the roll's input conv, the log-mel's over its T x n_mels, the
    mel projection, the step embedding, the output conv)."""
    levels = _levels(s)
    n0 = levels[0][2]
    init = s.dim // 3 * 2
    stem = (_conv(n0, 49, 1, init) + _conv(s.frames * s.n_mels, 49, 1, init)
            + 2.0 * init * s.frames * s.n_mels * s.pitches
            + 2.0 * s.dim * 4 * s.dim + 2.0 * 4 * s.dim * 4 * s.dim + _conv(n0, 1, s.dim, 1))
    lin = sum(linear_attention_flops(d_out, n) for _, d_out, n in levels)
    lin += sum(linear_attention_flops(d_in, n) for d_in, _, n in levels[1:])
    resample = 0.0
    for i, (_, d_out, _) in enumerate(levels[:-1]):
        resample += 2 * _conv(levels[i + 1][2], 16, d_out, d_out)     # both streams
    for d_in, _, n in levels[1:]:
        resample += 2 * _conv(n, 16, d_in, d_in)                      # transposed
    terms = {"blocks": sum(block_flops(s, *b) for b in _blocks(s)), "linear_attn": lin,
             "attn": attention_flops(levels[-1][1], levels[-1][2]), "resample": resample,
             "stem": stem}
    return {k: rows * v for k, v in terms.items()}


def forward_flops(s: UShape, rows: int = 1) -> float:
    return sum(forward_terms(s, rows).values())


def train_window_flops(s: UShape) -> float:
    """A training window's model operations: forward and backward, three
    times the forward, as `counts.train_window_flops` counts the stack's."""
    return 3.0 * forward_flops(s, 1)


def attn_bound_s(s: UShape, rows: int) -> float:
    """The least time of the bottleneck attention's two products over `rows`
    windows."""
    n = _levels(s)[-1][2]
    return bound_s(rows * attention_product_flops(n), rows * attention_bytes(n))


def blocks_bound_s(s: UShape, rows: int) -> float:
    """The least time of every ConvNeXt block's forward over `rows` windows."""
    blocks = _blocks(s)
    return bound_s(rows * sum(block_flops(s, *b) for b in blocks),
                   rows * sum(block_bytes(s, *b) for b in blocks))
