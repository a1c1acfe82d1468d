"""Operations and bytes of the port's kernels and of the whole step, from
shapes, term by term. They count the work these inputs need, whatever
implements it: a product over the conditioner's mel lanes counts the lanes
there are, and a projection that does not depend on the reverse step is
counted once a window. A multiply-add is two operations.

`cond_lanes` and `cond_streams` default to that count. PERF.md's table of
kernel bounds counted the kernels' own operands, the mel lanes padded to 256
and the constant spec := -1 stream projected like the conditional one; with
those two arguments the functions give its figures again.

Peaks: NVIDIA H100 SXM data sheet, dense, 700 W.
"""

from __future__ import annotations

from typing import NamedTuple

PEAK_BF16_FLOPS = 989e12     # dense bf16 tensor-core operations per second
PEAK_BYTES_PER_S = 3.35e12   # HBM3
F32, BF16 = 4, 2


class Shape(NamedTuple):
    """A configuration's widths as the counts need them."""

    channels: int       # C, the residual width
    layers: int         # L
    taps: int           # the dilated conv's kernel size
    n_mels: int         # conditioner lanes
    frames: int         # T, frames a window
    pitches: int = 88
    emb_in: int = 128   # the step table's width
    emb: int = 512      # the step embedding's width


def shape_of(cfg: dict) -> Shape:
    return Shape(cfg["residual_channels"], cfg["residual_layers"], cfg["kernel_size"],
                 cfg["n_mels"], cfg["frames"], cfg["pitches"])


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of operations over the
    bf16 peak and bytes over the memory rate."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S)


# ------------------------------------------------------------ forward terms

def stack_row_flops(s: Shape) -> float:
    """One row (one frame of one sequence) through the stack, per layer
    summed: the gate product over the taps (taps*C -> 2C) and the output
    product (C -> 2C). The conditioner's projection is counted apart."""
    return s.layers * (2.0 * s.taps * s.channels * 2 * s.channels
                       + 2.0 * s.channels * 2 * s.channels)


def cond_row_flops(s: Shape, cond_lanes: int = 0) -> float:
    """One row's conditioner projection for every layer (mel lanes -> 2C)."""
    return s.layers * 2.0 * (cond_lanes or s.n_mels) * 2 * s.channels


def head_row_flops(s: Shape) -> float:
    """One row's heads: input (88 -> C), skip (C -> C), output (C -> 88)."""
    return 2.0 * (s.pitches * s.channels + s.channels * s.channels + s.channels * s.pitches)


def step_embedding_flops(s: Shape) -> float:
    """One sequence's step embedding (two dense layers) and every layer's
    step projection (emb -> C): once a sequence a step, not once a row."""
    return 2.0 * (s.emb_in * s.emb + s.emb * s.emb) + s.layers * 2.0 * s.emb * s.channels


def forward_flops(s: Shape, seqs: int) -> float:
    """The denoiser's forward over `seqs` conditioned sequences."""
    rows = seqs * s.frames
    return (rows * (stack_row_flops(s) + cond_row_flops(s) + head_row_flops(s))
            + seqs * step_embedding_flops(s))


# ---------------------------------------------------------------- sampler K2

def k2_flops(s: Shape, batch: int, steps: int, guided: bool, cond_lanes: int = 0,
             cond_streams: int = 1) -> float:
    """One reverse process of `batch` windows: every step runs the stack and
    the heads over each stream's rows (two streams when guided); the
    conditioner's projection runs once a window for `cond_streams` streams
    (the spec := -1 stream's projection is a constant a layer)."""
    streams = 2 if guided else 1
    rows = streams * batch * s.frames
    per_step = rows * (stack_row_flops(s) + head_row_flops(s))
    return steps * per_step + cond_streams * batch * s.frames * cond_row_flops(s, cond_lanes)


def weight_bytes(s: Shape, cond_lanes: int = 0) -> float:
    """The stack's bf16 weights and f32 biases, the heads' f32 weights."""
    c, m = s.channels, cond_lanes or s.n_mels
    stack = s.layers * ((s.taps * c + m) * 2 * c * BF16 + c * 2 * c * BF16 + 3 * 2 * c * F32)
    heads = (s.pitches * c + c + c * c + c + c * s.pitches + s.pitches) * F32
    return stack + heads


def k2_bytes(s: Shape, batch: int, steps: int, cond_lanes: int = 0) -> float:
    """Each input read once and the result written once: x_T, the per-step
    noise, the step biases (steps, L, C), the step tables (steps, 3), the
    conditioner, the weights, x_0."""
    roll = batch * s.frames * s.pitches * F32
    return (roll * (2 + steps) + steps * s.layers * s.channels * F32 + steps * 3 * F32
            + batch * s.frames * s.n_mels * F32 + weight_bytes(s, cond_lanes))


def k2_bound_s(s: Shape, batch: int, steps: int, guided: bool) -> float:
    return bound_s(k2_flops(s, batch, steps, guided), k2_bytes(s, batch, steps))


def window_flops(s: Shape, steps: int, guided: bool) -> float:
    """A transcribed window's model operations: K2's work for one window
    plus the step embeddings (one a stream a step)."""
    streams = 2 if guided else 1
    return k2_flops(s, 1, steps, guided) + steps * streams * step_embedding_flops(s)


# ------------------------------------------------------------ training K3, K4

def k3_flops(s: Shape, batch: int, cond_lanes: int = 0) -> float:
    """The training forward of the stack over `batch` windows, the
    conditioner's projection inside it."""
    rows = batch * s.frames
    return rows * (stack_row_flops(s) + cond_row_flops(s, cond_lanes))


def k3_bytes(s: Shape, batch: int, cond_lanes: int = 0) -> float:
    """Inputs x (f32), the step biases, the conditioner; the skip output
    (f32) and the saves the backward reads (bf16 layer inputs and gate
    pre-activations); the weights."""
    rows = batch * s.frames
    c = s.channels
    return (rows * c * F32 + s.layers * batch * c * F32 + rows * s.n_mels * F32
            + rows * c * F32 + s.layers * rows * (c + 2 * c) * BF16
            + weight_bytes(s, cond_lanes))


def k4_flops(s: Shape, batch: int, cond_lanes: int = 0, dcond: bool = False) -> float:
    """The stack's backward, a layer: dWo (C x 2C over the rows), dg (the
    output cotangent through Wo), dWd and dWc (the gate weights over the
    taps and mel lanes), dy (the gate cotangent back through the taps), and
    dcond where asked."""
    rows = batch * s.frames
    c, m = s.channels, cond_lanes or s.n_mels
    per_layer = (2.0 * rows * c * 2 * c            # dWo
                 + 2.0 * rows * 2 * c * c          # dg
                 + 2.0 * rows * (s.taps * c + m) * 2 * c   # dWd, dWc
                 + 2.0 * rows * s.taps * 2 * c * c          # dy
                 + (2.0 * rows * 2 * c * m if dcond else 0.0))
    return s.layers * per_layer


def k4_bytes(s: Shape, batch: int, cond_lanes: int = 0) -> float:
    """Inputs: the saves, the conditioner, the step biases, the skip
    cotangent, the weights; outputs: dx, the step-bias gradients and the
    f32 weight gradients."""
    rows = batch * s.frames
    c, m = s.channels, cond_lanes or s.n_mels
    grads = s.layers * ((s.taps * c + m) * 2 * c + c * 2 * c + 2 * 2 * c) * F32
    return (s.layers * rows * 3 * c * BF16 + rows * s.n_mels * F32
            + 2 * s.layers * batch * c * F32 + 2 * rows * c * F32
            + weight_bytes(s, cond_lanes) + grads)


def train_window_flops(s: Shape) -> float:
    """A training window's model operations: forward and backward, three
    times the forward, each product counted once (nothing recomputed)."""
    return 3.0 * forward_flops(s, 1)
