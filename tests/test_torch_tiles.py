"""What surrounds the Hopper tile GEMM of the port's gated stack, on the CPU:
the widths the kernel takes, its tile list, the ping-pong schedule's walk of
it and its count of hidden epilogues, the frames its tap boxes cover
(held against `gated_stack_ref`'s shifts), the backward's walks (the weight
gradients box by box over whole-sequence splits, dy with the shift negated,
held against `bwd_ref`) and its split planner, and the C entry points' argument
lists against the ctypes signatures they are called with. The kernels
themselves run only on a card (tests/test_torch_kernels_gpu.py).
"""

import ctypes
import importlib
import re

import numpy as np
import pytest
import torch

from diffroll_tpu_torch import models as tmodels
from diffroll_tpu_torch.ops import _build

tgs = importlib.import_module("diffroll_tpu_torch.ops.gated_stack")
tgt = importlib.import_module("diffroll_tpu_torch.ops.gated_stack_train")

torch.set_num_threads(1)


def _kweights(c, layers, unconditional=False):
    name = "DiffRoll" if unconditional else "ClassifierFreeDiffRoll"
    kw = dict(residual_channels=c, residual_layers=layers, frames=16, timesteps=4)
    if unconditional:
        kw["unconditional"] = True
    torch.manual_seed(0)
    tm = tmodels.build(name, **kw)
    return tgs.kernel_weights(tgs.stack_weights(tm.net))


@pytest.mark.parametrize("c", [16, 32, 96, 160])
def test_kernel_refuses_channel_width(c):
    """C must be a multiple of the 64-wide k tile and column pair."""
    with pytest.raises(ValueError, match="multiple"):
        tgs.check_kernel_shapes(_kweights(c, 2), c, 2, torch.device("cpu"))


@pytest.mark.parametrize("mp", [229, 32, 96, 224])
def test_kernel_refuses_conditioner_width(mp):
    """The conditioner lanes are a K range of the gate GEMM: whole k tiles of 64."""
    kw = _kweights(64, 2)._replace(mp=mp)
    with pytest.raises(ValueError, match="multiple"):
        tgs.check_kernel_shapes(kw, 64, 2, torch.device("cpu"))


@pytest.mark.parametrize("c,unconditional", [(64, False), (128, False), (64, True)])
def test_kernel_takes_width(c, unconditional):
    kw = _kweights(c, 2, unconditional)
    assert kw.mp == (0 if unconditional else 256)  # 229 mel lanes padded to four k tiles
    tgs.check_kernel_shapes(kw, c, 2, torch.device("cpu"))
    with pytest.raises(ValueError, match="wcat"):  # the layouts are checked too
        tgs.check_kernel_shapes(kw._replace(wcat=kw.wcat.float()), c, 2, torch.device("cpu"))


def _preamble(kw, dilations=(1, 2), tb_shape=(2, 3, 64), cond_lanes=229):
    """`kernel_preamble` for 3 sequences of 8 frames at C=64 on the CPU."""
    cond = None if cond_lanes is None else torch.rand(3, 8, cond_lanes)
    return tgs.kernel_preamble(kw, (3, 8, 64), torch.device("cpu"), dilations,
                               torch.zeros(2, 3, 64), tb_shape, cond)


def test_kernel_preamble_prepares_every_wrappers_operands():
    """The time bias in f32, the conditioner zero-padded to the weights'
    256 lanes in bf16, the dilations as C ints."""
    tb, cond16, dil = _preamble(_kweights(64, 2))
    assert tb.dtype == torch.float32 and tuple(tb.shape) == (2, 3, 64)
    assert cond16.dtype == torch.bfloat16 and tuple(cond16.shape) == (3, 8, 256)
    assert torch.all(cond16[..., 229:] == 0) and list(dil) == [1, 2]
    assert _preamble(_kweights(64, 2, unconditional=True), cond_lanes=None)[1] is None


@pytest.mark.parametrize("case,match", [
    ("no_kweights", "kweights"), ("dilations", "3 dilations for 2 layers"),
    ("t_bias", "t_bias"), ("cond_without_rows", "without conditioner weights"),
    ("width", "multiple")])
def test_kernel_preamble_refuses(case, match):
    """Each wrapper's refusals, now made in one place."""
    kw = _kweights(64, 2)
    args = {"no_kweights": dict(kw=None), "dilations": dict(dilations=(1, 2, 4)),
            "t_bias": dict(tb_shape=(2, 4, 64)),
            "cond_without_rows": dict(kw=_kweights(64, 2, unconditional=True)),
            "width": dict(kw=kw._replace(mp=229))}[case]
    with pytest.raises(ValueError, match=match):
        _preamble(**{"kw": kw, **args})


@pytest.mark.parametrize("seqs,t_len,want", [
    (2, 640, [(b, t0) for b in range(2) for t0 in (0, 128, 256, 384, 512)]),
    (3, 100, [(0, 0), (1, 0), (2, 0)]),          # one ragged tile a sequence
    (2, 200, [(0, 0), (0, 128), (1, 0), (1, 128)]),  # the second tile holds 72 frames
    (1, 128, [(0, 0)]),
])
def test_stack_tiles(seqs, t_len, want):
    tiles = tgs.stack_tiles(seqs, t_len)
    assert tiles == want
    # every frame of every sequence lies in exactly one tile
    covered = sorted((b, t) for b, t0 in tiles for t in range(t0, min(t0 + tgs.BM, t_len)))
    assert covered == [(b, t) for b in range(seqs) for t in range(t_len)]


@pytest.mark.parametrize("seqs,t_len,c,tiles,waves", [
    (2, 640, 512, 80, 1),      # one clip, both guidance streams: 80 of 132 SMs
    (4, 640, 512, 160, 2),     # two clips: 132 + 28
    (16, 640, 512, 640, 5),    # a training batch
    (3, 100, 128, 6, 1),
    (2, 64, 64, 2, 1),
])
def test_tile_waves_as_the_source_note_quotes(seqs, t_len, c, tiles, waves):
    assert tgs.tile_waves(seqs, t_len, c) == (tiles, waves)


@pytest.mark.parametrize("ntiles,grid", [(640, 132), (320, 132), (80, 80), (2560, 132),
                                          (160, 132), (7, 3), (1, 1)])
def test_ping_pong_walk_deals_every_tile_once(ntiles, grid):
    """Every tile of a GEMM launch goes to exactly one (block, warpgroup),
    once: block b takes b, b + grid, ... and hands them to warpgroups 0, 1,
    0, ... in turn, each reading the next tile's k tiles of the ring."""
    walk = tgs.ping_pong_walk(ntiles, grid)
    assert len(walk) == grid
    dealt = sorted(tile for block in walk for tile, _, _ in block)
    assert dealt == list(range(ntiles))
    for b, block in enumerate(walk):
        assert [tile for tile, _, _ in block] == list(range(b, ntiles, grid))
        assert [wg for _, wg, _ in block] == [j % 2 for j in range(len(block))]
        assert [j for _, _, j in block] == list(range(len(block)))
    # a block's every tile but its last has its epilogue under the next one's k loop
    assert sum(len(block) - 1 for block in walk) == tgs.hidden_epilogues(ntiles, grid)


@pytest.mark.parametrize("seqs,c,hidden,ratio", [
    (16, 512, 508, 0.794),   # guided B=8: 640 tiles, 4-5 a block
    (8, 512, 188, 0.588),    # unguided B=8: 320 tiles, 2-3 a block
    (2, 512, 0, 0.0),        # guided B=1: 80 tiles, one a block
    (64, 512, 2428, 0.948),  # training at B=64: 2,560 tiles
])
def test_hidden_epilogues_as_the_source_note_quotes(seqs, c, hidden, ratio):
    """The share of forward GEMM tiles whose epilogue runs under the other
    warpgroup's k loop at the benchmark's shapes (132 SMs, T=640, 15 layers:
    2L GEMM launches a pass)."""
    tiles, _ = tgs.tile_waves(seqs, 640, c)
    assert tgs.hidden_epilogues(tiles, min(tiles, tgs.SMS)) == hidden
    pass_tiles, pass_hidden = tgs.pass_tiles(seqs, 640, c, 15)
    assert (pass_tiles, pass_hidden) == (30 * tiles, 30 * hidden)
    assert round(pass_hidden / pass_tiles, 3) == ratio


def _kernel_body(src, name):
    """The source of a __global__ kernel, from its name to the next one."""
    start = re.search(r"\b" + name + r"\(", src).start()
    nxt = src.find("__global__", start)
    return src[start:nxt if nxt > 0 else len(src)]


@pytest.mark.parametrize("kernel", ["nt_kernel", "wgrad_kernel"])
def test_backward_keeps_the_cooperative_schedule(kernel):
    """K4's GEMMs are TileGemm's cooperative consumers (both warpgroups on one
    tile); the ping-pong schedule is the forward kernels' alone."""
    src = (_build.SRC_DIR / "gated_stack_train.cu").read_text()
    assert re.search(r"using TileNT = sm90::TileGemm<", src)
    assert re.search(r"using TileTN = sm90::TileGemm<", src)
    body = _kernel_body(src, kernel)
    assert "gemm.consume(d, ln.wg, nk, it)" in body
    assert "PingPong" not in src and "consume_tiles" not in src and "setmaxnreg" not in src


@pytest.mark.parametrize("kernel", ["gate_kernel", "out_kernel"])
def test_forward_kernels_take_the_ping_pong_schedule(kernel):
    src = (_build.SRC_DIR / "gated_stack.cu").read_text()
    body = _kernel_body(src, kernel)
    assert re.search(r"gemm\.consume_tiles\(\s*p\.ntiles,\s*nk,", body)
    assert "regs_dec<G::PRODUCER_REGS>" in body and "regs_inc<G::CONSUMER_REGS>" in body


def _box(y, b, frames):
    """What the copy brings in for sequence b: the named frames, zero outside [0, T)."""
    t_len = y.shape[1]
    out = torch.zeros(len(frames), y.shape[2])
    for i, t in enumerate(frames):
        if 0 <= t < t_len:
            out[i] = y[b, t]
    return out


@pytest.mark.parametrize("t_len,dilation", [(100, 8), (100, 1), (200, 8), (8, 8), (64, 128)],
                         ids=["T100_d8", "T100_d1", "T200_d8", "d_eq_T", "d_gt_T"])
def test_tap_boxes_are_the_plain_versions_shifts(t_len, dilation):
    """Tap j of a tile is the box at frame t0 + (j - taps/2) * d, zero-filled
    outside its own sequence: the same rows `gated_stack_ref` gets by shifting
    (all of them zero once the dilation reaches T)."""
    taps, seqs, c = 3, 2, 4
    rng = np.random.default_rng(0)
    y = torch.from_numpy(rng.standard_normal((seqs, t_len, c)).astype(np.float32))
    for j in range(taps):
        shifted = tgs._shift(y, (j - taps // 2) * dilation)
        for b, t0 in tgs.stack_tiles(seqs, t_len):
            frames = tgs.tap_frames(t0, j, taps, dilation)
            assert len(frames) == tgs.BM and frames[0] == t0 + (j - 1) * dilation
            rows = min(tgs.BM, t_len - t0)  # a ragged tile's rows past T are not stored
            assert torch.equal(_box(y, b, frames)[:rows], shifted[b, t0:t0 + rows])


def test_tiled_gate_product_matches_plain_layer():
    """One layer's pre-gate activation assembled tile by tile from tap boxes
    and the concatenated weights, as the kernel's K loop walks them, against
    the plain version's shifts and per-tap products."""
    c, t_len, seqs, dilation = 64, 100, 2, 8
    kw = _kweights(c, 1)
    rng = np.random.default_rng(1)
    y = torch.from_numpy(rng.standard_normal((seqs, t_len, c)).astype(np.float32))
    cond = torch.from_numpy(rng.random((seqs, t_len, 229)).astype(np.float32))
    wcat = kw.wcat[0].float()
    cond_p = tgs.pad_cond(cond, kw.mp)
    got = torch.zeros(seqs, t_len, 2 * c)
    for b, t0 in tgs.stack_tiles(seqs, t_len):
        a_tile = torch.cat([_box(y, b, tgs.tap_frames(t0, j, kw.taps, dilation))
                            for j in range(kw.taps)]
                           + [_box(cond_p, b, range(t0, t0 + tgs.BM))], dim=1)
        rows = min(tgs.BM, t_len - t0)
        got[b, t0:t0 + rows] = (a_tile @ wcat)[:rows]
    wd = wcat[:kw.taps * c].reshape(kw.taps, c, 2 * c)
    want = sum(tgs._shift(y, (j - 1) * dilation) @ wd[j] for j in range(kw.taps)) \
        + cond_p @ wcat[kw.taps * c:]
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def _one_layer_case(t_len, dilation, seqs=3, c=8, mels=5, mp=8):
    """A one-layer stack's saves and what its backward multiplies: with L = 1
    the sweep's operands follow from the saves in a few lines (dout = [0, cot],
    the gate's derivative), so the kernel's walks can be laid over them and
    held against `bwd_ref`'s gradients."""
    rng = np.random.default_rng(t_len * 1000 + dilation)

    def arr(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32))

    w = tgs.GatedStackWeights(
        wd=arr(1, 3, c, 2 * c, scale=0.3), wc=torch.cat([arr(1, mels, 2 * c, scale=0.3),
                                                          torch.zeros(1, mp - mels, 2 * c)], 1),
        wo=arr(1, c, 2 * c, scale=0.3), b=arr(1, 2 * c), bc=arr(1, 2 * c), bo=arr(1, 2 * c),
        wt=None, bt=None)
    x, tb, cond, cot = arr(seqs, t_len, c), arr(1, seqs, c, scale=0.1), arr(seqs, t_len, mels), \
        arr(seqs, t_len, c)
    _, xs, a = tgt.fwd_saves_ref(x, tb, cond, w, [dilation])
    ref = tgt.bwd_ref([dilation], (tb, cond, w, xs, a), cot)
    s1, th = torch.sigmoid(a[0][..., :c]), torch.tanh(a[0][..., c:])
    dout = torch.cat([torch.zeros_like(cot), cot], -1)
    dg = dout @ w.wo[0].t()
    da = torch.cat([dg * th * s1 * (1 - s1), dg * s1 * (1 - th * th)], -1)
    ops = dict(y=xs[0] + tb[0][:, None, :], g=s1 * th, dout=dout, da=da,
               cond=tgs.pad_cond(cond, mp))
    return w, ops, ref


def _wgrad_walk(a_op, b_op, splits, shift):
    """sum over the splits, in order, of each split's boxes' A_box^T @ B_box."""
    seqs, t_len, _ = a_op.shape
    parts = []
    for boxes in tgt.wgrad_boxes(seqs, t_len, splits):
        acc = torch.zeros(a_op.shape[2], b_op.shape[2])
        for b, f0 in boxes:
            a_box = _box(a_op, b, range(f0 + shift, f0 + shift + tgt.WGRAD_BOX))
            acc = acc + a_box.t() @ _box(b_op, b, range(f0, f0 + tgt.WGRAD_BOX))
        parts.append(acc)
    out = parts[0]
    for part in parts[1:]:
        out = out + part
    return out


WALK_CASES = [(100, 1), (100, 8), (100, 128), (8, 1), (8, 8), (8, 128)]
WALK_IDS = [f"T{t}_d{d}" for t, d in WALK_CASES]


@pytest.mark.parametrize("splits", [1, 2, 3])
@pytest.mark.parametrize("t_len,dilation", WALK_CASES, ids=WALK_IDS)
def test_wgrad_walk_matches_plain_backward(t_len, dilation, splits):
    """The weight gradients assembled as wgrad_kernel walks them: 64-frame
    boxes of one sequence, y's box shifted by the tap, both boxes zero-filled
    outside [0, T) (a ragged last box, a tap that leaves the clip, a dilation
    past T), whole-sequence splits added in order."""
    w, ops, ref = _one_layer_case(t_len, dilation)
    dw = ref[3]
    taps = w.wd.shape[1]
    assert [len(b) for b in tgt.wgrad_boxes(3, t_len, splits)] == \
        [n * -(-t_len // 64) for n in ((3,), (2, 1), (1, 1, 1))[splits - 1]]
    for j in range(taps):
        frames = tgt.wgrad_tap_frames(0, j, taps, dilation)
        assert len(frames) == tgt.WGRAD_BOX and frames[0] == (j - taps // 2) * dilation
        got = _wgrad_walk(ops["y"], ops["da"], splits, frames[0])
        torch.testing.assert_close(got, dw.wd[0, j], atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(_wgrad_walk(ops["cond"], ops["da"], splits, 0), dw.wc[0],
                               atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(_wgrad_walk(ops["g"], ops["dout"], splits, 0), dw.wo[0],
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("t_len,dilation", WALK_CASES + [(200, 8)], ids=WALK_IDS + ["T200_d8"])
def test_dy_walk_matches_plain_backward(t_len, dilation):
    """dx of a one-layer stack (= dy) assembled tile by tile: tap j's A box is
    da16 at frame t0 - (j - taps/2) d, zero-filled outside its own sequence,
    against W_j^T."""
    w, ops, ref = _one_layer_case(t_len, dilation)
    taps = w.wd.shape[1]
    got = torch.zeros_like(ref[0])
    for b in range(got.shape[0]):
        for t0 in range(0, t_len, tgt.BWD_TILE):
            rows = min(tgt.BWD_TILE, t_len - t0)
            tile = sum(_box(ops["da"], b, tgt.dy_tap_frames(t0, j, taps, dilation)) @ w.wd[0, j].t()
                       for j in range(taps))
            got[b, t0:t0 + rows] = tile[:rows]
    torch.testing.assert_close(got, ref[0], atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("seqs,t_len,rows,cols,want", [
    (16, 640, 1792, 1024, (1, 16, 112, 1)),  # a training batch, dW: 112 tiles unsplit on 132 SMs
    (16, 640, 512, 1024, (4, 4, 128, 1)),    # ... dWo: 32 tiles in 4 splits of 4 sequences
    (2, 640, 1792, 1024, (1, 2, 112, 1)),    # one clip's two streams
    (2, 640, 512, 1024, (2, 1, 64, 1)),
    (1, 640, 512, 1024, (1, 1, 32, 1)),      # one sequence cannot be split
    (3, 100, 640, 256, (3, 1, 30, 1)),
    (64, 640, 512, 1024, (4, 16, 128, 1)),
])
def test_wgrad_plan_as_the_source_note_quotes(seqs, t_len, rows, cols, want):
    plan = tgt.wgrad_plan(seqs, t_len, rows, cols)
    assert plan == want
    splits, per_split, items, waves = plan
    assert (splits - 1) * per_split < seqs <= splits * per_split  # no split is empty
    assert items == splits * (rows // 128) * (cols // 128) and waves == -(-items // tgs.SMS)


@pytest.mark.parametrize("seqs,t_len,splits", [(16, 640, 4), (3, 100, 2), (5, 8, 5), (2, 200, 1)])
def test_wgrad_boxes_cover_every_frame_once(seqs, t_len, splits):
    boxes = [bx for split in tgt.wgrad_boxes(seqs, t_len, splits) for bx in split]
    covered = sorted((b, t) for b, f0 in boxes for t in range(f0, min(f0 + 64, t_len)))
    assert covered == [(b, t) for b in range(seqs) for t in range(t_len)]
    assert boxes == sorted(boxes)  # sequences in order, a sequence's boxes in order


_C_TYPES = {"int": ctypes.c_int, "float": ctypes.c_float}


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_ctypes_signature_matches_the_c_entry(name):
    """A wrong ctypes list is silent (a pointer cut to 32 bits, a float read
    as an int): hold each list against the entry's parameters in the source."""
    src = "\n".join(p.read_text() for p in sorted(_build.SRC_DIR.glob("*.cu")))
    found = re.findall(r"\bint\s+" + name + r"\s*\(([^)]*)\)\s*\{", src)
    assert len(found) == 1, f"{name}: {len(found)} definitions"
    want = []
    for param in found[0].split(","):
        param = " ".join(param.split())
        want.append(ctypes.c_void_p if "*" in param
                    else _C_TYPES[param.replace("const ", "").split()[0]])
    assert _build.SIGNATURES[name] == want
