"""Operations of SpecUnet's guided reverse process: `counts/spec_unet.py`'s
terms of the forward split by stream. The spectrogram stream reads neither
x nor t, so sampling computes it once a batch (`SpecUnetNet.cond_projections`,
for both guidance branches) and runs the x stream alone every step; the last
block's spectrogram net, whose output nothing reads, it does not compute.
Counted as `counts/spec_unet.py` counts (a multiply-add two operations; norms,
nonlinearities, softmaxes and sums not counted). One row is one 640-frame
window.
"""

from __future__ import annotations

from typing import Dict

from .spec_unet import UShape, _blocks, _conv, _levels, attention_flops, linear_attention_flops


def block_terms(s: UShape, d_in: int, spec_in: int, d_out: int, n: int,
                lift: bool) -> Dict[str, float]:
    """`spec_unet.block_flops` by part: `x` (the x stream's depthwise 7x7,
    step projection, two 3x3 convs and residual conv), `spec` (the
    spectrogram's 7x7, which the x stream adds in) and `spec_net` (the
    spectrogram stream's two 3x3 convs)."""
    mid = d_out * s.convnext_mult
    spec_mid = d_in if lift else spec_in
    x = (_conv(n, 49, 1, d_in) + 2.0 * 4 * s.dim * d_in
         + _conv(n, 9, d_in, mid) + _conv(n, 9, mid, d_out))
    if d_in != d_out:
        x += _conv(n, 1, d_in, d_out)
    spec = _conv(n, 49, spec_in, d_in) if lift else _conv(n, 49, 1, spec_in)
    return {"x": x, "spec": spec, "spec_net": _conv(n, 9, spec_mid, mid) + _conv(n, 9, mid, d_out)}


def stream_terms(s: UShape, rows: int = 1) -> Dict[str, float]:
    """The forward's operations over `rows` windows by stream: `x`, `spec`
    (the spectrogram stream as sampling computes it) and `dropped` (the last
    block's spectrogram net, which sampling leaves out); the three add up to
    `spec_unet.forward_flops`."""
    levels = _levels(s)
    n0, init = levels[0][2], s.dim // 3 * 2
    x = (_conv(n0, 49, 1, init) + 2.0 * s.dim * 4 * s.dim + 2.0 * 4 * s.dim * 4 * s.dim
         + _conv(n0, 1, s.dim, 1))
    spec = _conv(s.frames * s.n_mels, 49, 1, init) + 2.0 * init * s.frames * s.n_mels * s.pitches
    x += sum(linear_attention_flops(d_out, n) for _, d_out, n in levels)
    x += sum(linear_attention_flops(d_in, n) for d_in, _, n in levels[1:])
    x += attention_flops(levels[-1][1], levels[-1][2])
    for i, (_, d_out, _) in enumerate(levels[:-1]):   # each stream's down-sampler
        x += _conv(levels[i + 1][2], 16, d_out, d_out)
        spec += _conv(levels[i + 1][2], 16, d_out, d_out)
    for d_in, _, n in levels[1:]:                     # each stream's up-sampler
        x += _conv(n, 16, d_in, d_in)
        spec += _conv(n, 16, d_in, d_in)
    blocks = [block_terms(s, *b) for b in _blocks(s)]
    x += sum(b["x"] for b in blocks)
    spec += sum(b["spec"] for b in blocks) + sum(b["spec_net"] for b in blocks[:-1])
    return {"x": rows * x, "spec": rows * spec, "dropped": rows * blocks[-1]["spec_net"]}


def window_flops(s: UShape, timesteps: int) -> float:
    """A window's model operations under guided sampling: the x stream every
    step and the spectrogram stream once, each on both guidance branches. A
    route that runs the whole forward every step does 2.28x these at the
    published widths and T=200."""
    t = stream_terms(s)
    return 2.0 * (timesteps * t["x"] + t["spec"])
