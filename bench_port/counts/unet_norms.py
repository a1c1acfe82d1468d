"""SpecUnet's forward GroupNorms (`diffroll_tpu_torch/nn/unet.py`
`SpecUnetNet`), from its widths: every call's (channels, positions) and the
calls' least time, each input read once and each output written once in f32
at HBM's rate. A norm does a few operations a value, so bytes bound it.
Built on `spec_unet.py`'s `_levels` and `_blocks`.
"""

from __future__ import annotations

from typing import List, Tuple

from . import F32, PEAK_BYTES_PER_S
from .spec_unet import UShape, _blocks, _levels


def norms(s: UShape) -> List[Tuple[int, int]]:
    """(channels, positions) of every forward GroupNorm, by kind (not in
    call order): four a block (each stream's norm before its first 3x3 conv
    and before its second), two a linear attention (its pre-norm and the
    norm after its output conv), one before the bottleneck's attention."""
    out = []
    for d_in, spec_in, d_out, n, lift in _blocks(s):
        mid = d_out * s.convnext_mult
        out += [(d_in, n), (mid, n), (d_in if lift else spec_in, n), (mid, n)]
    levels = _levels(s)
    for _, d_out, n in levels:
        out += [(d_out, n)] * 2
    for d_in, _, n in levels[1:]:
        out += [(d_in, n)] * 2
    out.append((levels[-1][1], levels[-1][2]))
    return out


def elements(s: UShape, rows: int = 1) -> int:
    """Values normalised in a forward over `rows` windows."""
    return rows * sum(c * n for c, n in norms(s))


def norms_bound_s(s: UShape, rows: int) -> float:
    """The least time of the forward's GroupNorms over `rows` windows."""
    return 2 * F32 * elements(s, rows) / PEAK_BYTES_PER_S
