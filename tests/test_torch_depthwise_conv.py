"""The U-Net's depthwise 7x7 route on the CPU (`diffroll_tpu_torch/ops/depthwise_conv.py`,
`nn/unet.py::DepthwiseConv2d`); its kernels are held on the card by
tests/test_torch_kernels_gpu.py.

  * `strip_plan`: at every shape of SpecUnet's 24 forward depthwise convs and
    the unconditional U-Net's, at B=16 and B=1, every output is computed by
    exactly one thread, every input it needs is staged in its block, and the
    blocks fill two waves of the card wherever the planes can be split so far;
  * a numpy mirror of the kernels' order (the stencil's taps, the weight
    gradient's per-thread sums, warp butterflies, warps in order, then the
    partials over n and blocks) against F.conv2d's gradients in f64;
  * the module stays an `nn.Conv2d` (state-dict keys, the model axis's own
    sharded route), CPU inputs never reach the kernels, and a call the
    kernels cannot take raises;
  * `bench_port/counts/unet_dwconvs.py` against forward hooks of the port.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from bench_port.counts import spec_unet, unet_dwconvs
from diffroll_tpu_torch.nn import unet
from diffroll_tpu_torch.ops import depthwise_conv as dw
from diffroll_tpu_torch.parallel import model_axis

torch.set_num_threads(1)

# (C, H, W) of SpecUnet's 24 forward depthwise convs at its published widths
# (8 distinct), and of UnetNet's at its defaults (dim 28)
SPEC_UNET_CONVS = [(18, 640, 88), (28, 320, 44), (28, 640, 88), (56, 160, 22), (56, 320, 44),
                   (112, 160, 22), (168, 320, 44), (336, 160, 22)]
UNET_CONVS = [(18, 640, 88), (28, 320, 44), (28, 640, 88), (56, 160, 22), (56, 320, 44),
              (112, 160, 22), (112, 320, 44), (224, 160, 22)]


def dwconv_shapes(module, *args):
    """Input shapes of every DepthwiseConv2d call of `module(*args)`, in call
    order, by forward hooks (on the meta device it costs no work)."""
    seen = []
    hooks = [m.register_forward_hook(lambda mod, inp, out: seen.append(tuple(inp[0].shape)))
             for m in module.modules() if isinstance(m, unet.DepthwiseConv2d)]
    try:
        with torch.no_grad():
            module(*args)
    finally:
        for h in hooks:
            h.remove()
    return seen


def test_the_listed_shapes_are_the_ports():
    with torch.device("meta"):
        spec, plain = unet.SpecUnetNet(), unet.UnetNet()
        x, t, cond = torch.empty(1, 640, 88), torch.empty(1), torch.empty(1, 640, 229)
    shapes = dwconv_shapes(spec, x, t, cond)
    assert len(shapes) == 24
    assert sorted({s[1:] for s in shapes}) == SPEC_UNET_CONVS
    assert sorted({s[1:] for s in dwconv_shapes(plain, x, t)}) == UNET_CONVS


# ------------------------------------------------------------------ the plan

def _blocks(plan: dw.Plan):
    """Each block's (r0, x0) in launch order (blockIdx.x = strip x tiles +
    tile)."""
    return [(s * plan.th, t * 4 * plan.ncg) for s in range(plan.strips) for t in range(plan.tiles)]


def _unit_outputs(plan: dw.Plan, r0: int, x0: int, u: int):
    """(rows, cols) a thread unit computes, before the plane's edges cut it."""
    cg, run = u % plan.ncg, u // plan.ncg
    rows = np.arange(r0 + run * dw.RH, r0 + (run + 1) * dw.RH)
    cols = np.arange(x0 + 4 * cg, x0 + 4 * cg + 4)
    return rows, cols


@pytest.mark.parametrize("batch", [1, 16])
@pytest.mark.parametrize("c,h,w", sorted(set(SPEC_UNET_CONVS + UNET_CONVS)))
def test_the_plan_covers_every_output_once(c, h, w, batch):
    planes = batch * c
    plan = dw.strip_plan(planes, h, w)
    assert plan.th % dw.RH == 0 and plan.units <= plan.threads <= dw.THREADS
    assert plan.threads % 32 == 0 and plan.ncg <= dw.MAX_GROUPS
    assert (plan.strips - 1) * plan.th < h <= plan.strips * plan.th
    assert (plan.tiles - 1) * 4 * plan.ncg < w <= plan.tiles * 4 * plan.ncg
    covered = np.zeros((h, w), np.int64)
    for r0, x0 in _blocks(plan):
        # the staged rows and columns: r0 - 3 .. r0 + th + 2, x0 - 4 .. x0 + 4 ncg + 3
        staged_r = (r0 - dw.PAD, r0 + plan.th + dw.PAD)
        staged_c = (x0 - 4, x0 + 4 * plan.ncg + 4)
        for u in range(plan.units):
            rows, cols = _unit_outputs(plan, r0, x0, u)
            assert staged_r[0] <= rows[0] - dw.PAD and rows[-1] + dw.PAD < staged_r[1]
            assert staged_c[0] <= cols[0] - dw.PAD and cols[-1] + dw.PAD < staged_c[1]
            rows, cols = rows[rows < h], cols[cols < w]
            covered[np.ix_(rows, cols)] += 1
    assert (covered == 1).all()
    # two waves of the card, unless every plane is already cut to RH-row strips
    blocks = planes * plan.strips * plan.tiles
    assert blocks >= dw.TARGET_BLOCKS or plan.th == dw.RH


@pytest.mark.parametrize("planes,h,w", [(1, 5, 3), (3, 37, 13), (2, 9, 300), (4096, 640, 88),
                                        (1, 2048, 1)])
def test_the_plan_takes_odd_shapes(planes, h, w):
    """Ragged rows and columns, a width cut into column tiles, a plane a
    block's strip covers whole."""
    plan = dw.strip_plan(planes, h, w)
    assert (plan.strips - 1) * plan.th < h <= plan.strips * plan.th
    assert (plan.tiles - 1) * 4 * plan.ncg < w <= plan.tiles * 4 * plan.ncg
    assert plan.units <= plan.threads <= dw.THREADS
    if w == 300:
        assert plan.tiles == 3 and plan.ncg == 25


# ------------------------------------------------------------ the numpy mirror

WARP = 32


def _padded(a: np.ndarray, plan: dw.Plan, top: int, left: int) -> np.ndarray:
    """`a` (N, C, H, W) in zeros of the launch's whole staged extent: `top`
    rows and `left` columns before, enough after."""
    n, c, h, w = a.shape
    out = np.zeros((n, c, plan.strips * plan.th + 2 * top, plan.tiles * 4 * plan.ncg + 2 * left),
                   np.float32)
    out[:, :, top:top + h, left:left + w] = a
    return out


def mirror_stencil(x: np.ndarray, taps: np.ndarray, bias) -> np.ndarray:
    """The kernels' stencil in numpy f32: out = bias, then the 49 taps added
    in row-major order (each a product and a sum where the kernel fuses
    them)."""
    n, c, h, w = x.shape
    xp = np.zeros((n, c, h + 6, w + 6), np.float32)
    xp[:, :, 3:3 + h, 3:3 + w] = x
    out = np.zeros_like(x) if bias is None else np.broadcast_to(
        bias.astype(np.float32)[None, :, None, None], x.shape).copy()
    for i in range(dw.K):
        for j in range(dw.K):
            out = out + taps[None, :, i, j, None, None] * xp[:, :, i:i + h, j:j + w]
    return out


def mirror_wgrad(x: np.ndarray, dy: np.ndarray, plan: dw.Plan):
    """dw (C, 7, 7) and db (C) as the kernels sum them, in numpy f32: each
    thread's sums over its RH x 4 outputs (rows, then columns, in order),
    the butterfly over each warp's lanes (l with l ^ 16, .. l ^ 1), the
    block's warps in order, then each channel's partials over n and the
    plane's blocks in order."""
    n, c, h, w = x.shape
    th, strips, ncg, tiles = plan
    runs = th // dw.RH
    xp = _padded(x, plan, dw.PAD, 4)          # staged: 3 rows, 4 columns of zeros before
    dyp = _padded(dy, plan, 0, 0)
    # a thread's dy: (n, c, strip, tile, run, cg, k, q)
    d = dyp.reshape(n, c, strips, runs, dw.RH, tiles, ncg, 4).transpose(0, 1, 2, 5, 3, 6, 4, 7)
    # a thread's staged x: rows run RH + 0 .. RH + 5 of its strip, columns 4 cg + 0 .. 11
    rr = (np.arange(strips)[:, None, None, None, None, None] * th
          + np.arange(runs)[None, None, :, None, None, None] * dw.RH
          + np.arange(dw.RH + 6)[None, None, None, None, :, None])
    cc = (np.arange(tiles)[None, :, None, None, None, None] * 4 * ncg
          + np.arange(ncg)[None, None, None, :, None, None] * 4
          + np.arange(12)[None, None, None, None, None, :])
    xw = xp[:, :, rr, cc]                      # (n, c, strip, tile, run, cg, RH + 6, 12)
    acc = np.zeros(d.shape[:6] + (dw.PART,), np.float32)
    for k in range(dw.RH):
        for q in range(4):
            acc[..., dw.K * dw.K] += d[..., k, q]
    for k in range(dw.RH):
        for q in range(4):
            win = xw[..., k:k + dw.K, q + 1:q + 1 + dw.K].reshape(d.shape[:6] + (dw.K * dw.K,))
            acc[..., :dw.K * dw.K] += d[..., k, q, None] * win
    # the block's threads u = run ncg + cg, then idle threads to whole warps
    acc = acc.reshape(n, c, strips, tiles, runs * ncg, dw.PART)
    lanes = np.zeros((n, c, strips, tiles, plan.threads, dw.PART), np.float32)
    lanes[:, :, :, :, :plan.units] = acc
    lanes = lanes.reshape(n, c, strips, tiles, plan.threads // WARP, WARP, dw.PART)
    idx = np.arange(WARP)
    for m in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[:, :, :, :, :, idx ^ m]
    warps = lanes[:, :, :, :, :, 0]            # every lane holds the same sums
    part = warps[:, :, :, :, 0].copy()
    for k in range(1, plan.threads // WARP):
        part = part + warps[:, :, :, :, k]
    part = part.reshape(n, c, strips * tiles, dw.PART)
    total = np.zeros((c, dw.PART), np.float32)
    for i in range(n):
        for b in range(strips * tiles):
            total = total + part[i, :, b]
    return total[:, :dw.K * dw.K].reshape(c, dw.K, dw.K), total[:, dw.K * dw.K]


def _f64_grads(x, taps, bias, dy):
    leaves = [torch.tensor(a, dtype=torch.float64, requires_grad=True) for a in (x, taps, bias)]
    y = F.conv2d(leaves[0], leaves[1][:, None], leaves[2], padding=dw.PAD, groups=x.shape[1])
    y.backward(torch.tensor(dy, dtype=torch.float64))
    return [y.detach().numpy()] + [t.grad.numpy() for t in leaves]


def _rel(got, want) -> float:
    return float(np.abs(got.astype(np.float64) - want).max() / np.abs(want).max())


@pytest.mark.parametrize("n,c,h,w", [(2, 3, 640, 88), (16, 2, 320, 44), (16, 3, 160, 22),
                                     (1, 2, 37, 13), (2, 2, 9, 300)],
                         ids=["640x88", "320x44_b16", "160x22_b16", "ragged", "column_tiles"])
def test_the_mirrored_kernels_match_f64(n, c, h, w):
    """y, dx, dw and db as the kernels compute them, each within 1e-6 of
    F.conv2d's in f64 over the largest reference value."""
    rng = np.random.default_rng(n * 1000 + c * 100 + h + w)
    x = (0.5 + rng.standard_normal((n, c, h, w))).astype(np.float32)
    dy = rng.standard_normal((n, c, h, w)).astype(np.float32)
    taps = (rng.standard_normal((c, dw.K, dw.K)) / dw.K).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    y64, dx64, dw64, db64 = _f64_grads(x, taps, bias, dy)
    plan = dw.strip_plan(n * c, h, w)
    got_dw, got_db = mirror_wgrad(x, dy, plan)
    assert _rel(mirror_stencil(x, taps, bias), y64) < 1e-6
    assert _rel(mirror_stencil(dy, taps[:, ::-1, ::-1], None), dx64) < 1e-6
    assert _rel(got_dw, dw64) < 1e-6
    assert _rel(got_db, db64) < 1e-6


def test_the_mirrors_butterfly_adds_every_thread_once():
    """With one-hot sums the mirror's merge counts each thread of each block
    once: dw of all ones is the plane's positions that see the tap."""
    n, c, h, w = 2, 1, 20, 9
    x = np.ones((n, c, h, w), np.float32)
    dy = np.ones((n, c, h, w), np.float32)
    got_dw, got_db = mirror_wgrad(x, dy, dw.strip_plan(n * c, h, w))
    rows = np.array([h - abs(i - dw.PAD) for i in range(dw.K)])
    cols = np.array([w - abs(j - dw.PAD) for j in range(dw.K)])
    assert np.array_equal(got_dw[0], n * np.outer(rows, cols).astype(np.float32))
    assert got_db[0] == n * h * w


# ------------------------------------------------------------------ the module

def test_conv_gives_the_depthwise_class_exactly_where_each_channel_has_its_filter():
    assert type(unet.conv(8, 8, 7, groups=8)) is unet.DepthwiseConv2d
    for args, kw in (((8, 8, 7), {}), ((8, 16, 7), {"groups": 8}), ((1, 12, 7), {}),
                     ((8, 8, 3), {"groups": 4})):
        assert type(unet.conv(*args, **kw)) is torch.nn.Conv2d, (args, kw)
    m = unet.conv(8, 8, 7, groups=8)
    assert isinstance(m, torch.nn.Conv2d) and list(m.state_dict()) == ["weight", "bias"]
    assert tuple(m.weight.shape) == (8, 1, 7, 7) and m.padding == (3, 3)
    mp = model_axis._column_class(type(m))
    assert issubclass(mp, unet.DepthwiseConv2d)
    assert mp._conv_forward is model_axis._ColumnConv._conv_forward


def test_the_nets_keys_and_dense_convs_are_unchanged():
    """Every block's `ds_conv` and the non-lifting `spec_ds_conv` are
    depthwise; the stems and the up path's lifting convs stay dense; the
    parameter names and shapes are what they were."""
    torch.manual_seed(0)
    net = unet.SpecUnetNet(dim=8)
    kinds = {name: type(m) for name, m in net.named_modules()
             if isinstance(m, torch.nn.Conv2d) and name.endswith(("ds_conv", "init_conv"))}
    depthwise = sorted(k for k, t in kinds.items() if t is unet.DepthwiseConv2d)
    assert len(depthwise) == 24
    assert all(k.endswith("ds_conv") for k in depthwise)
    dense = sorted(k for k, t in kinds.items() if t is torch.nn.Conv2d)
    assert dense == ["init_conv", "spec_init_conv", "up_0_block1.spec_ds_conv",
                     "up_1_block1.spec_ds_conv"]
    for name in depthwise:
        m = net.get_submodule(name)
        assert m.groups == m.in_channels == m.out_channels
        assert tuple(m.weight.shape) == (m.in_channels, 1, 7, 7)
    sd = net.state_dict()
    assert "down_0_block1.ds_conv.weight" in sd and "up_0_block1.spec_ds_conv.weight" in sd


def test_cpu_inputs_never_reach_the_kernels(monkeypatch):
    def refuse(*args):
        raise AssertionError("a CPU input reached DepthwiseConvFn")

    monkeypatch.setattr(dw.DepthwiseConvFn, "apply", refuse)
    before = dw.depthwise_conv.launches
    torch.manual_seed(0)
    net = unet.SpecUnetNet(dim=8)
    x = torch.randn(2, 16, 88)
    out = net(x, torch.tensor([3, 5]), torch.randn(2, 16, 229))
    out.square().mean().backward()
    convs = [m for m in net.modules() if isinstance(m, unet.DepthwiseConv2d)]
    assert len(convs) == 24
    assert all(m.weight.grad is not None for m in convs)
    m = unet.conv(6, 6, 7, groups=6)
    xs = torch.randn(3, 6, 5, 11)
    assert torch.equal(m(xs), F.conv2d(xs, m.weight, m.bias, padding=3, groups=6))
    assert dw.depthwise_conv.launches == before


def _meta(*shape, dtype=torch.float32):
    return torch.empty(*shape, device="meta", dtype=dtype)


@pytest.mark.parametrize("x,weight,bias,kw", [
    (_meta(2, 8, 16, 16, dtype=torch.float64), _meta(8, 1, 7, 7), _meta(8), {}),
    (_meta(2, 8, 16, 16, dtype=torch.bfloat16), _meta(8, 1, 7, 7), _meta(8), {}),
    (_meta(2 ** 21, 1, 32, 32), _meta(1, 1, 7, 7), _meta(1), {}),          # 2**31 values
    (_meta(2, 8, 0, 16), _meta(8, 1, 7, 7), _meta(8), {}),
    (_meta(8, 16, 16), _meta(8, 1, 7, 7), _meta(8), {}),
    (_meta(2, 8, 16, 16), _meta(8, 1, 3, 3), _meta(8), {"padding": 1}),
    (_meta(2, 8, 16, 16), _meta(8, 1, 5, 7), _meta(8), {}),
    (_meta(2, 8, 16, 16), _meta(8, 1, 7, 7), _meta(8), {"stride": 2}),
    (_meta(2, 8, 16, 16), _meta(8, 1, 7, 7), _meta(8), {"padding": 0}),
    (_meta(2, 8, 16, 16), _meta(8, 1, 7, 7), _meta(8), {"dilation": 2}),
    (_meta(2, 8, 16, 16), _meta(8, 1, 7, 7, dtype=torch.float16), _meta(8), {}),
    (_meta(2, 8, 16, 16), _meta(4, 1, 7, 7), _meta(4), {}),
    (_meta(2, 8, 16, 16), _meta(8, 1, 7, 7), torch.zeros(8), {}),          # another device
], ids=["f64", "bf16", "2**31", "empty", "3-d", "kernel_3", "kernel_5x7", "stride", "padding",
        "dilation", "f16_weight", "weight_size", "bias_device"])
def test_a_call_the_kernels_cannot_take_raises(x, weight, bias, kw):
    with pytest.raises(ValueError):
        dw.check(x, weight, bias, **kw)


def test_the_kernels_take_any_layout_of_f32_and_no_bias():
    """A transposed input passes the check (`depthwise_conv` hands the
    kernels a contiguous copy); so do a missing bias and the module's tuple
    arguments; 2**31 - 1 values is the most."""
    x = _meta(16, 28, 88, 640).transpose(2, 3)
    dw.check(x, _meta(28, 1, 7, 7), None)
    dw.check(x, _meta(28, 1, 7, 7), _meta(28), (1, 1), (3, 3), (1, 1))
    dw.check(_meta(2 ** 31 - 1, 1, 1, 1), _meta(1, 1, 7, 7), _meta(1))


# ------------------------------------------------------------------ the counts

@pytest.mark.parametrize("dim,frames", [(28, 32), (8, 32)], ids=["published", "tiny"])
def test_dwconv_counts_match_the_ports_inputs(dim, frames):
    """`unet_dwconvs.elements` against the sum of every DepthwiseConv2d input
    of a CPU forward, by hooks; at the published widths over 32 frames, and
    at dim 8."""
    cfg = {"residual_channels": dim, "dim_mults": [1, 2, 4], "convnext_mult": 2,
           "n_mels": 229, "frames": frames, "pitches": 88}
    torch.manual_seed(0)
    net = unet.SpecUnetNet(dim=dim)
    shapes = dwconv_shapes(net, torch.randn(2, frames, 88), torch.tensor([1, 2]),
                           torch.randn(2, frames, 229))
    s = spec_unet.shape_of(cfg)
    assert len(shapes) == len(unet_dwconvs.convs(s)) == 24
    assert sum(int(np.prod(sh)) for sh in shapes) == unet_dwconvs.elements(s, 2)
    assert sorted((sh[1], sh[2] * sh[3]) for sh in shapes) == sorted(unet_dwconvs.convs(s))


def test_dwconv_counts_at_the_cells_shape():
    s = spec_unet.UShape()
    assert unet_dwconvs.elements(s) == 18_191_360
    assert unet_dwconvs.elements(s, 16) == 291_061_760
    assert unet_dwconvs.dwconvs_bound_s(s, 16) == pytest.approx(2 * 4 * 291_061_760 / 3.35e12)
