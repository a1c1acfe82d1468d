"""The U-Net's GroupNorm route on the CPU (`diffroll_tpu_torch/ops/group_norm.py`,
`nn/unet.py::GroupNorm`); its kernels are held on the card by
tests/test_torch_kernels_gpu.py.

  * `split_plan`: every reduction of SpecUnet's 63 forward norms, and of a
    ResNet-block U-Net's 8-group norms, at B=16 and B=1, fills two waves of
    the card wherever the rows alone do not;
  * `row_stats`, a numpy mirror of the kernels' Welford threads, Chan
    trees and fixed-order merge of a row's partials, against f64 statistics;
  * the module stays an `nn.GroupNorm` (state-dict keys, the model axis's
    gathered-parameter forward), CPU inputs never reach the kernels, and a
    call the kernels cannot take raises;
  * `bench_port/counts/unet_norms.py` against forward hooks of the port.
"""

from typing import Tuple

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from bench_port.counts import spec_unet, unet_norms
from diffroll_tpu_torch.nn import unet
from diffroll_tpu_torch.ops import group_norm as gn
from diffroll_tpu_torch.parallel import model_axis

torch.set_num_threads(1)
EPS = unet.GN_EPS

# ------------------------------------------------------------ the numpy mirror

THREADS, VEC = gn.THREADS, gn.VEC   # a block's threads; values a load


def _merge(a, b):
    """Chan's merge of (count, mean, M2) arrays, in the kernel's f32 order."""
    n = a[0] + b[0]
    with np.errstate(divide="ignore", invalid="ignore"):
        f = np.where(n > 0, b[0] / np.where(n > 0, n, 1), np.float32(0)).astype(np.float32)
    d = b[1] - a[1]
    return n, a[1] + d * f, a[2] + b[2] + d * d * a[0] * f


def _tree(s):
    """A shuffle tree over the last axis (32 lanes): lane i takes lane i +
    off, off = 16 .. 1; lane 0's result."""
    s = tuple(np.array(v) for v in s)
    off = s[0].shape[-1] // 2
    while off:
        lo = tuple(v[..., :off] for v in s)
        hi = tuple(v[..., off:2 * off] for v in s)
        s = _merge(lo, hi)
        off //= 2
    return tuple(v[..., 0] for v in s)


def _pad_lanes(s, lanes: int = 32):
    """Empty (0, 0, 0) entries after the last axis's to `lanes`."""
    extra = lanes - s[0].shape[-1]
    return tuple(np.concatenate([v, np.zeros(v.shape[:-1] + (extra,), np.float32)], -1)
                 for v in s)


def row_stats(row: np.ndarray, splits: int, chunk: int, eps: float) -> Tuple[float, float]:
    """(mean, rstd) of one row as the kernels compute them, in numpy f32:
    per block, thread t's Welford over the groups of 4 values t, t + 256, ...
    of the block's chunk; a tree in each warp, then over the 8 warps; then
    the row's partials, lane j taking partials j, j + 32, ... in order, and a
    tree over the lanes."""
    x = np.asarray(row, np.float32)
    length = x.size
    groups = chunk // VEC
    iters = -(-groups // THREADS)
    padded = np.zeros(splits * chunk, np.float32)
    padded[:length] = x
    # (split, iteration, thread, value): group g = iteration * THREADS + thread
    v = np.zeros((splits, iters * THREADS, VEC), np.float32)
    v[:, :groups] = padded.reshape(splits, groups, VEC)
    v = v.reshape(splits, iters, THREADS, VEC)
    start = (np.arange(splits)[:, None, None] * chunk
             + (np.arange(iters)[None, :, None] * THREADS + np.arange(THREADS)) * VEC)
    in_chunk = (np.arange(iters)[None, :, None] * THREADS + np.arange(THREADS)) < groups
    m = np.where(in_chunk, np.clip(length - start, 0, VEC), 0).astype(np.float32)
    total = v[..., 0].copy()
    for k in range(1, VEC):
        total = np.where(m > k, total + v[..., k], total)
    with np.errstate(divide="ignore", invalid="ignore"):
        mean = np.where(m > 0, total / np.where(m > 0, m, 1), 0).astype(np.float32)
    m2 = (v[..., 0] - mean) * (v[..., 0] - mean)
    for k in range(1, VEC):
        d = v[..., k] - mean
        m2 = np.where(m > k, m2 + d * d, m2)
    m2 = np.where(m > 0, m2, 0).astype(np.float32)
    s = (np.zeros((splits, THREADS), np.float32),) * 3
    for it in range(iters):
        s = _merge(s, (m[:, it], mean[:, it], m2[:, it]))
    warps = _tree(tuple(a.reshape(splits, THREADS // 32, 32) for a in s))
    blocks = _tree(_pad_lanes(warps))
    # the row's partials: lane j takes partials j, j + 32, ... in order
    rounds = -(-splits // 32)
    lanes = tuple(np.zeros(rounds * 32, np.float32) for _ in range(3))
    for dst, src in zip(lanes, blocks):
        dst[:splits] = src
    acc = (np.zeros(32, np.float32),) * 3
    for r in range(rounds):
        acc = _merge(acc, tuple(a[r * 32:(r + 1) * 32] for a in lanes))
    _, mu, m2_row = _tree(acc)
    var = np.float32(m2_row) / np.float32(length)
    return float(mu), float(np.float32(1) / np.sqrt(var + np.float32(eps)))


# (channels, positions) of SpecUnet's 63 forward norms at its published widths
# (11 distinct; every one has a single group), and the 8-group norms of
# UnetNet(dim=32, use_convnext=False)
SPEC_UNET_NORMS = [(18, 56320), (28, 14080), (28, 56320), (56, 3520), (56, 14080),
                   (56, 56320), (112, 3520), (112, 14080), (168, 14080), (224, 3520),
                   (336, 3520)]
RESNET_NORMS = [(32, 14080), (32, 56320), (64, 3520), (64, 14080), (128, 3520)]
CASES = ([(c, n, 1) for c, n in SPEC_UNET_NORMS] + [(c, n, 8) for c, n in RESNET_NORMS]
         + [(3, 77, 1)])   # rows of 231 values: a short last group of 3


def norm_shapes(module, *args):
    """(input shape, groups) of every GroupNorm call of `module(*args)`, in
    call order, by forward hooks (on the meta device it costs no work)."""
    seen = []
    hooks = [m.register_forward_hook(
        lambda mod, inp, out: seen.append((tuple(inp[0].shape), mod.num_groups)))
        for m in module.modules() if isinstance(m, torch.nn.GroupNorm)]
    try:
        with torch.no_grad():
            module(*args)
    finally:
        for h in hooks:
            h.remove()
    return seen


def _meta_shapes(net, frames: int, n_mels: int = 229):
    with torch.device("meta"):
        args = (torch.empty(1, frames, 88), torch.empty(1), torch.empty(1, frames, n_mels))
    return norm_shapes(net, *args)


def test_the_listed_shapes_are_the_ports():
    with torch.device("meta"):
        spec, resnet = unet.SpecUnetNet(), unet.UnetNet(dim=32, use_convnext=False)
    shapes = _meta_shapes(spec, 640)
    assert len(shapes) == 63 and {g for _, g in shapes} == {1}
    assert sorted({(s[1], s[2] * s[3]) for s, _ in shapes}) == SPEC_UNET_NORMS
    with torch.device("meta"):
        x, t = torch.empty(1, 640, 88), torch.empty(1)
    grouped = {(s[1], s[2] * s[3]) for s, g in norm_shapes(resnet, x, t) if g == 8}
    assert sorted(grouped) == RESNET_NORMS


@pytest.mark.parametrize("batch", [1, 16])
@pytest.mark.parametrize("channels,positions,groups", CASES[:-1])
def test_the_plan_fills_two_waves(channels, positions, groups, batch):
    rows, length = batch * groups, channels // groups * positions
    for n_rows, n in ((rows, length), (batch * channels, positions)):   # the norm, the planes
        splits, chunk = gn.split_plan(n_rows, n)
        assert chunk % gn.VEC == 0 and (splits - 1) * chunk < n <= splits * chunk
        assert n_rows * splits >= 2 * gn.SMS or n_rows >= 2 * gn.SMS
        if n_rows >= gn.TARGET_BLOCKS:
            assert splits == 1


def test_the_plan_takes_one_block_a_row_where_rows_fill_the_card():
    assert gn.split_plan(gn.TARGET_BLOCKS, 10 ** 6) == (1, 10 ** 6)
    assert gn.split_plan(1, 100) == (1, 100)          # shorter than a block's least chunk
    assert gn.split_plan(16, 3 * gn.MIN_CHUNK) == (3, gn.MIN_CHUNK)


@pytest.mark.parametrize("batch", [1, 16])
@pytest.mark.parametrize("channels,positions,groups", CASES)
def test_the_mirrored_statistics_match_f64(channels, positions, groups, batch):
    """One row of the call's plan (every row of a call has the same plan):
    mean within 1e-6 of the row's scale (max(|mean|, std)), rstd within 1e-6
    relative."""
    length = channels // groups * positions
    rng = np.random.default_rng(channels * 7 + positions + batch)
    row = (0.5 + 2.0 * rng.standard_normal(length)).astype(np.float32)
    splits, chunk = gn.split_plan(batch * groups, length)
    mean, rstd = row_stats(row, splits, chunk, EPS)
    r64 = row.astype(np.float64)
    mean64, std64 = r64.mean(), r64.std()
    assert abs(mean - mean64) <= 1e-6 * max(abs(mean64), std64)
    assert abs(rstd * np.sqrt(std64 ** 2 + EPS) - 1.0) <= 1e-6


def test_the_mirror_merges_partials_exactly():
    """An empty side of Chan's merge leaves the other's bits; a row cut into
    single groups per block gives the same statistics as in one block."""
    a = tuple(np.array([v], np.float32) for v in (4.0, 0.3, 1.7))
    empty = tuple(np.zeros(1, np.float32) for _ in range(3))
    for got in (_merge(a, empty), _merge(empty, a)):
        assert all(np.array_equal(g, w) for g, w in zip(got, a))
    row = np.arange(64, dtype=np.float32)
    whole = row_stats(row, 1, 64, EPS)
    split = row_stats(row, 16, 4, EPS)
    assert whole == pytest.approx(split, rel=1e-6)
    assert whole[0] == pytest.approx(31.5)


# ------------------------------------------------------------------ the module

def test_group_norm_stays_an_nn_group_norm():
    m = unet.group_norm(16, 8)
    assert isinstance(m, torch.nn.GroupNorm) and type(m) is unet.GroupNorm
    assert (m.num_groups, m.num_channels, m.eps) == (8, 16, EPS)
    assert list(m.state_dict()) == ["weight", "bias"]
    mp = model_axis._column_class(type(m))
    assert issubclass(mp, unet.GroupNorm)
    assert mp.forward is model_axis._GatheredGroupNorm.forward


def test_cpu_inputs_never_reach_the_kernels(monkeypatch):
    def refuse(*args):
        raise AssertionError("a CPU input reached GroupNormFn")

    monkeypatch.setattr(gn.GroupNormFn, "apply", refuse)
    before = gn.group_norm.launches
    torch.manual_seed(0)
    net = unet.SpecUnetNet(dim=8)
    x = torch.randn(2, 16, 88)
    out = net(x, torch.tensor([3, 5]), torch.randn(2, 16, 229))
    out.square().mean().backward()
    norms = [m for m in net.modules() if isinstance(m, unet.GroupNorm)]
    # the last block's spectrogram net is computed and dropped
    assert sum(m.weight.grad is not None for m in norms) == len(norms) - 2
    m = unet.group_norm(6)
    xs = torch.randn(3, 6, 5, 7)
    assert torch.equal(m(xs), F.group_norm(xs, 1, m.weight, m.bias, EPS))
    assert gn.group_norm.launches == before


def _meta(*shape, dtype=torch.float32):
    return torch.empty(*shape, device="meta", dtype=dtype)


@pytest.mark.parametrize("x,weight,bias,groups", [
    (_meta(2, 8, 4, 4, dtype=torch.float64), _meta(8), _meta(8), 1),
    (_meta(2, 8, 4, 4, dtype=torch.bfloat16), _meta(8), _meta(8), 1),
    (_meta(2 ** 21, 32, 32), _meta(32), _meta(32), 1),              # 2**31 values
    (_meta(2, 8, 0, 4), _meta(8), _meta(8), 1),
    (_meta(2, 8), _meta(8), _meta(8), 1),
    (_meta(2, 8, 4, 4), _meta(8), _meta(8), 3),
    (_meta(2, 8, 4, 4), None, None, 1),
    (_meta(2, 8, 4, 4), _meta(8, dtype=torch.float16), _meta(8), 1),
    (_meta(2, 8, 4, 4), _meta(4), _meta(4), 1),
    (_meta(2, 8, 4, 4), torch.ones(8), torch.zeros(8), 1),         # another device
], ids=["f64", "bf16", "2**31", "empty", "2-d", "groups", "no_affine", "f16_weight",
        "weight_size", "weight_device"])
def test_a_call_the_kernels_cannot_take_raises(x, weight, bias, groups):
    with pytest.raises(ValueError):
        gn.check(x, weight, bias, groups)


def test_the_kernels_take_any_layout_of_f32():
    """A transposed input passes the check: `group_norm` hands the kernels a
    contiguous copy of it."""
    x = _meta(16, 28, 640, 88).transpose(2, 3)
    gn.check(x, _meta(28), _meta(28), 1)
    gn.check(_meta(2 ** 21 - 1, 32, 32), _meta(32), _meta(32), 8)


# ------------------------------------------------------------------ the counts

@pytest.mark.parametrize("dim,frames", [(28, 32), (8, 32)], ids=["published", "tiny"])
def test_norm_counts_match_the_ports_norm_inputs(dim, frames):
    """`unet_norms.elements` against the sum of every GroupNorm input of a
    CPU forward, by hooks; at the published widths over 32 frames, and at
    dim 8."""
    cfg = {"residual_channels": dim, "dim_mults": [1, 2, 4], "convnext_mult": 2,
           "n_mels": 229, "frames": frames, "pitches": 88}
    torch.manual_seed(0)
    net = unet.SpecUnetNet(dim=dim)
    shapes = norm_shapes(net, torch.randn(2, frames, 88), torch.tensor([1, 2]),
                            torch.randn(2, frames, 229))
    s = spec_unet.shape_of(cfg)
    assert len(shapes) == len(unet_norms.norms(s)) == 63
    assert sum(int(np.prod(sh)) for sh, _ in shapes) == unet_norms.elements(s, 2)
    assert sorted((sh[1], sh[2] * sh[3]) for sh, _ in shapes) == sorted(unet_norms.norms(s))


def test_norm_counts_at_the_cells_shape():
    s = spec_unet.UShape()
    assert unet_norms.elements(s) == 65_105_920
    assert unet_norms.norms_bound_s(s, 16) == pytest.approx(2 * 4 * 16 * 65_105_920 / 3.35e12)
