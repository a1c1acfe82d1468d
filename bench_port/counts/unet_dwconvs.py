"""SpecUnet's forward depthwise 7x7 convolutions (`diffroll_tpu_torch/nn/unet.py`
`SpecUnetNet`: every block's `ds_conv`, and its `spec_ds_conv` where that is
not the up path's dense lift), from its widths: every call's (channels,
positions) and the calls' least time, each input read once and each output
written once in f32 at HBM's rate. A call does 49 multiply-adds a value,
under half the card's f32 rate against those bytes, so bytes bound it.
Built on `spec_unet.py`'s `_blocks`.
"""

from __future__ import annotations

from typing import List, Tuple

from . import F32, PEAK_BYTES_PER_S
from .spec_unet import UShape, _blocks


def convs(s: UShape) -> List[Tuple[int, int]]:
    """(channels, positions) of every forward depthwise conv, by block: x's,
    then the spectrogram's unless the block lifts it with a dense 7x7."""
    out = []
    for d_in, spec_in, _, n, lift in _blocks(s):
        out.append((d_in, n))
        if not lift:
            out.append((spec_in, n))
    return out


def elements(s: UShape, rows: int = 1) -> int:
    """Channel-positions convolved in a forward over `rows` windows."""
    return rows * sum(c * n for c, n in convs(s))


def dwconvs_bound_s(s: UShape, rows: int) -> float:
    """The least time of the forward's depthwise convs over `rows` windows."""
    return 2 * F32 * elements(s, rows) / PEAK_BYTES_PER_S
