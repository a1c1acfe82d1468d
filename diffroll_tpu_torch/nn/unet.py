"""U-Net denoisers over piano rolls (counterpart of `diffroll_tpu/nn/unet.py`):
`UnetNet` (unconditional) and `SpecUnetNet` (a parallel spectrogram stream
merged into every block, its skips concatenated into the up path).

Rolls are (B, C, T, 88) images here; the JAX package runs (B, T, 88, C), so
a flax kernel (kT, k88, I, O) is a Conv2d weight (O, I, kT, k88). Module
names follow the flax scopes (`init_conv`, `down_0_block1.ds_conv`,
`mid_attn`, `up_1_us`, `final_conv`, ...); flax's automatic names become
`conv1`, `norm1`, `linear1` (`Conv_0`, `GroupNorm_0`, `Dense_0`), and the
attention of `down_0_attn` is its `fn` (flax hangs it under the parent as
`LinearAttention_0`). `compat.state_dict_from_jax` does the renaming.

flax defaults kept: GroupNorm epsilon 1e-6, the tanh approximation of GELU,
'SAME' convolutions. Attention is computed as the JAX package computes it,
with einsum and softmax.

Spans (`utils/profiling.py::span`, a `user_annotation` while a profile
records, else one check), the forward's only:

  unet.block         every ConvNeXt (or ResNet) block; a SpecUnet block's
                     two streams together
  unet.linear_attn   every `PreNormResidual(LinearAttention)`
  unet.attn          the bottleneck's `PreNormResidual(Attention)`
  unet.resample      every down- and up-sampler (a SpecUnet level's two
                     streams together)
  unet.norm          every GroupNorm, inside `unet.block`, `unet.linear_attn`
                     or `unet.attn`
  unet.dwconv        every depthwise 7x7 conv, inside `unet.block`

Every norm is a `GroupNorm`: an `nn.GroupNorm` (same arguments, `weight` and
`bias`) whose forward runs the port's kernels on CUDA inputs
(`ops/group_norm.py`) and `F.group_norm` on CPU ones. Every depthwise conv
(`groups` equal to both widths: the blocks' `ds_conv` and the non-lifting
`spec_ds_conv`) is a `DepthwiseConv2d`, likewise an `nn.Conv2d` whose
convolution runs `ops/depthwise_conv.py`'s kernels on CUDA inputs and
`F.conv2d` on CPU ones; the dense 7x7s (`init_conv`, `spec_init_conv`, the
up path's lifting `spec_ds_conv`) stay `nn.Conv2d`.

`attn_rows` counts the rows (sequences) through the bottleneck's full
attention in this process.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import depthwise_conv as dw_ops
from ..ops import group_norm as gn_ops
from ..utils.profiling import span
from .init import dense, lecun_normal

GN_EPS = 1e-6    # flax nn.GroupNorm's default (PyTorch's is 1e-5)
HEADS, DIM_HEAD = 4, 32
attn_rows = 0   # rows through `Attention`, the bottleneck's full attention


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax nn.gelu: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


class GroupNorm(nn.GroupNorm):
    """`nn.GroupNorm` whose forward takes `ops.group_norm.group_norm`: the
    port's kernels on CUDA inputs, `F.group_norm` on CPU ones."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("unet.norm"):
            return gn_ops.group_norm(x, self.num_groups, self.weight, self.bias, self.eps)


def group_norm(channels: int, groups: int = 1) -> nn.GroupNorm:
    return GroupNorm(groups, channels, eps=GN_EPS)


class DepthwiseConv2d(nn.Conv2d):
    """`nn.Conv2d` with one filter a channel whose convolution takes
    `ops.depthwise_conv.depthwise_conv`: the port's kernels on CUDA inputs,
    `F.conv2d` on CPU ones."""

    def _conv_forward(self, x: torch.Tensor, weight: torch.Tensor,
                      bias: Optional[torch.Tensor]) -> torch.Tensor:
        with span("unet.dwconv"):
            return dw_ops.depthwise_conv(x, weight, bias, self.stride, self.padding,
                                         self.dilation)


def conv(in_ch: int, out_ch: int, k: int, groups: int = 1, bias: bool = True) -> nn.Conv2d:
    """A stride-1 'SAME' convolution (odd k); a `DepthwiseConv2d` where each
    channel has its own filter (groups == in_ch == out_ch)."""
    cls = DepthwiseConv2d if groups == in_ch == out_ch else nn.Conv2d
    return lecun_normal(cls(in_ch, out_ch, k, padding=k // 2, groups=groups, bias=bias))


def _same_padding(n: int, k: int, s: int) -> Tuple[int, int]:
    """lax 'SAME' padding of one axis: the output has ceil(n / s) positions."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class Downsample(nn.Conv2d):
    """A 4x4 stride-2 'SAME' convolution: 1 row of padding on each side at
    even sizes, one more after at odd ones."""

    def __init__(self, dim: int):
        super().__init__(dim, dim, 4, stride=2)
        lecun_normal(self)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (h0, h1), (w0, w1) = (_same_padding(n, 4, 2) for n in x.shape[-2:])
        return super().forward(F.pad(x, (w0, w1, h0, h1)))


def upsample(dim: int) -> nn.ConvTranspose2d:
    """The exact 2x upsampler. flax's ConvTranspose(4, stride 2, 'SAME') with
    transpose_kernel=False correlates the zero-dilated input, padded by 2, with
    the kernel as it is; ConvTranspose2d(4, 2, padding=1) is the same with the
    kernel flipped in both spatial axes, which `state_dict_from_jax` does."""
    return lecun_normal(nn.ConvTranspose2d(dim, dim, 4, stride=2, padding=1))


class SinusoidalTimeEmbedding(nn.Module):
    """t (B,) -> sin/cos of dim // 2 frequencies -> Linear, GELU, Linear:
    (B, 4 dim)."""

    def __init__(self, dim: int):
        super().__init__()
        self.half = dim // 2
        self.linear1 = dense(2 * self.half, 4 * dim)
        self.linear2 = dense(4 * dim, 4 * dim)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        freqs = torch.exp(torch.arange(self.half, device=t.device, dtype=torch.float32)
                          * -(math.log(10000.0) / (self.half - 1)))
        ang = t.float()[:, None] * freqs[None, :]
        emb = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
        return self.linear2(gelu(self.linear1(emb)))


class ConvNextBlock(nn.Module):
    """Depthwise 7x7, plus the time bias, then GroupNorm, 3x3 conv (x mult),
    GELU, GroupNorm, 3x3 conv; a residual (1x1 `res_conv` when the width
    changes)."""

    def __init__(self, dim_in: int, dim_out: int, time_dim: int, mult: int = 2):
        super().__init__()
        self.ds_conv = conv(dim_in, dim_in, 7, groups=dim_in)
        self.time_mlp = dense(time_dim, dim_in)
        self.norm1 = group_norm(dim_in)
        self.conv1 = conv(dim_in, dim_out * mult, 3)
        self.norm2 = group_norm(dim_out * mult)
        self.conv2 = conv(dim_out * mult, dim_out, 3)
        self.res_conv = conv(dim_in, dim_out, 1) if dim_in != dim_out else None

    def forward(self, x: torch.Tensor, t_emb: Optional[torch.Tensor] = None) -> torch.Tensor:
        with span("unet.block"):
            h = self.ds_conv(x)
            if t_emb is not None:
                h = h + self.time_mlp(gelu(t_emb))[:, :, None, None]
            h = self.conv2(self.norm2(gelu(self.conv1(self.norm1(h)))))
            return h + (x if self.res_conv is None else self.res_conv(x))


class ResnetBlock(nn.Module):
    """Two 3x3 convs, each followed by GroupNorm and SiLU, the time bias
    between them; a residual (`model.use_convnext=false`)."""

    def __init__(self, dim_in: int, dim_out: int, time_dim: int, groups: int = 8):
        super().__init__()
        self.conv1 = conv(dim_in, dim_out, 3)
        self.norm1 = group_norm(dim_out, groups)
        self.time_mlp = dense(time_dim, dim_out)
        self.conv2 = conv(dim_out, dim_out, 3)
        self.norm2 = group_norm(dim_out, groups)
        self.res_conv = conv(dim_in, dim_out, 1) if dim_in != dim_out else None

    def forward(self, x: torch.Tensor, t_emb: Optional[torch.Tensor] = None) -> torch.Tensor:
        with span("unet.block"):
            h = F.silu(self.norm1(self.conv1(x)))
            if t_emb is not None:
                h = h + self.time_mlp(F.silu(t_emb))[:, :, None, None]
            h = F.silu(self.norm2(self.conv2(h)))
            return h + (x if self.res_conv is None else self.res_conv(x))


def _heads(qkv: torch.Tensor):
    """(B, 3 heads dh, H, W) -> q, k, v, each (B, heads, H W, dh)."""
    b, _, h, w = qkv.shape
    return qkv.reshape(b, 3, HEADS, DIM_HEAD, h * w).transpose(-1, -2).unbind(1)


def _merge(out: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, heads, H W, dh) -> (B, heads dh, H, W)."""
    b, heads, _, dh = out.shape
    return out.transpose(-1, -2).reshape(b, heads * dh, h, w)


class Attention(nn.Module):
    """Full softmax attention over all H x W positions (the bottleneck only)."""

    def __init__(self, dim: int):
        super().__init__()
        self.to_qkv = conv(dim, 3 * HEADS * DIM_HEAD, 1, bias=False)
        self.to_out = conv(HEADS * DIM_HEAD, dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        global attn_rows
        attn_rows += x.shape[0]
        q, k, v = _heads(self.to_qkv(x))
        sim = torch.einsum("bhid,bhjd->bhij", q * DIM_HEAD ** -0.5, k)
        out = torch.einsum("bhij,bhjd->bhid", sim.softmax(dim=-1), v)
        return self.to_out(_merge(out, *x.shape[-2:]))


class LinearAttention(nn.Module):
    """O(N) attention: q softmaxed over its features, k over the positions,
    one shared k^T v context; then the output conv (`conv1`) and GroupNorm."""

    def __init__(self, dim: int):
        super().__init__()
        self.to_qkv = conv(dim, 3 * HEADS * DIM_HEAD, 1, bias=False)
        self.conv1 = conv(HEADS * DIM_HEAD, dim, 1)
        self.norm1 = group_norm(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = _heads(self.to_qkv(x))
        q = q.softmax(dim=-1) * DIM_HEAD ** -0.5
        k = k.softmax(dim=-2)
        context = torch.einsum("bhnd,bhne->bhde", k, v)
        out = torch.einsum("bhde,bhnd->bhne", context, q)
        return self.norm1(self.conv1(_merge(out, *x.shape[-2:])))


class PreNormResidual(nn.Module):
    """x + fn(GroupNorm(x)), in the span of its attention's kind."""

    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.norm1 = group_norm(dim)
        self.fn = fn
        self.span_name = "unet.attn" if isinstance(fn, Attention) else "unet.linear_attn"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span(self.span_name):
            return x + self.fn(self.norm1(x))


def _levels(dim: int, dim_mults) -> Tuple[int, list]:
    """The stem width and the (in, out) widths of each resolution level."""
    init_dim = dim // 3 * 2
    dims = [init_dim] + [dim * m for m in dim_mults]
    return init_dim, list(zip(dims[:-1], dims[1:]))


class UnetNet(nn.Module):
    """Unconditional roll denoiser: (B, T, 88) noisy roll + (B,) t -> (B, T, 88)."""

    def __init__(self, dim: int = 28, dim_mults=(1, 2, 4), use_convnext: bool = True,
                 convnext_mult: int = 2, resnet_block_groups: int = 8):
        super().__init__()
        init_dim, in_out = _levels(dim, dim_mults)
        self.n_levels = len(in_out)
        time_dim = 4 * dim

        def block(d_in, d_out):
            if use_convnext:
                return ConvNextBlock(d_in, d_out, time_dim, convnext_mult)
            return ResnetBlock(d_in, d_out, time_dim, resnet_block_groups)

        self.init_conv = conv(1, init_dim, 7)
        self.time_mlp = SinusoidalTimeEmbedding(dim)
        for i, (d_in, d_out) in enumerate(in_out):
            self.add_module(f"down_{i}_block1", block(d_in, d_out))
            self.add_module(f"down_{i}_block2", block(d_out, d_out))
            self.add_module(f"down_{i}_attn", PreNormResidual(d_out, LinearAttention(d_out)))
            if i < self.n_levels - 1:
                self.add_module(f"down_{i}_ds", Downsample(d_out))
        width = in_out[-1][1]
        self.mid_block1 = block(width, width)
        self.mid_attn = PreNormResidual(width, Attention(width))
        self.mid_block2 = block(width, width)
        for i, (d_in, d_out) in enumerate(reversed(in_out[1:])):
            self.add_module(f"up_{i}_block1", block(width + d_out, d_in))
            self.add_module(f"up_{i}_block2", block(d_in, d_in))
            self.add_module(f"up_{i}_attn", PreNormResidual(d_in, LinearAttention(d_in)))
            self.add_module(f"up_{i}_us", upsample(d_in))
            width = d_in
        self.final_block = block(width, dim)
        self.final_conv = conv(dim, 1, 1)

    def forward(self, x: torch.Tensor, t: torch.Tensor, cond=None, uncond_mask=None):
        del cond, uncond_mask  # the unconditional family
        m = self._modules
        x = self.init_conv(x[:, None])
        t_emb = self.time_mlp(t)
        skips = []
        for i in range(self.n_levels):
            x = m[f"down_{i}_block2"](m[f"down_{i}_block1"](x, t_emb), t_emb)
            x = m[f"down_{i}_attn"](x)
            skips.append(x)
            if i < self.n_levels - 1:
                with span("unet.resample"):
                    x = m[f"down_{i}_ds"](x)
        x = self.mid_block2(self.mid_attn(self.mid_block1(x, t_emb)), t_emb)
        for i in range(self.n_levels - 1):
            x = m[f"up_{i}_block1"](torch.cat([x, skips.pop()], dim=1), t_emb)
            x = m[f"up_{i}_attn"](m[f"up_{i}_block2"](x, t_emb))
            with span("unet.resample"):
                x = m[f"up_{i}_us"](x)
        return self.final_conv(self.final_block(x, t_emb))[:, 0]


class SpecConvNextBlock(nn.Module):
    """A ConvNext block with a parallel spectrogram stream, merged additively
    into x before the block's net; returns (x_out, spec_out). In the up path
    (`spec_dense_lift`) x has three times the width and the spectrogram keeps
    its own, lifted by a dense 7x7 conv instead of the depthwise one."""

    def __init__(self, dim_in: int, spec_in: int, dim_out: int, time_dim: int,
                 mult: int = 2, spec_dense_lift: bool = False):
        super().__init__()
        self.ds_conv = conv(dim_in, dim_in, 7, groups=dim_in)
        if spec_dense_lift:
            self.spec_ds_conv = conv(spec_in, dim_in, 7)
            spec_mid = dim_in
        else:
            self.spec_ds_conv = conv(spec_in, spec_in, 7, groups=spec_in)
            spec_mid = spec_in
        self.time_mlp = dense(time_dim, dim_in)
        for prefix, width in (("net_", dim_in), ("spec_net_", spec_mid)):
            self.add_module(f"{prefix}norm1", group_norm(width))
            self.add_module(f"{prefix}conv1", conv(width, dim_out * mult, 3))
            self.add_module(f"{prefix}norm2", group_norm(dim_out * mult))
            self.add_module(f"{prefix}conv2", conv(dim_out * mult, dim_out, 3))
        self.res_conv = conv(dim_in, dim_out, 1) if dim_in != dim_out else None

    def _net(self, z: torch.Tensor, prefix: str) -> torch.Tensor:
        m = self._modules
        z = m[f"{prefix}conv1"](m[f"{prefix}norm1"](z))
        return m[f"{prefix}conv2"](m[f"{prefix}norm2"](gelu(z)))

    def forward(self, x, spec, t_emb=None):
        with span("unet.block"):
            h = self.ds_conv(x)
            spec_h = self.spec_ds_conv(spec)
            if t_emb is not None:
                h = h + spec_h + self.time_mlp(gelu(t_emb))[:, :, None, None]
            res = x if self.res_conv is None else self.res_conv(x)
            return self._net(h, "net_") + res, self._net(spec_h, "spec_net_")


class SpecUnetNet(nn.Module):
    """Spectrogram-conditioned U-Net: (B, T, 88) roll + (B,) t + (B, T, n_mels)
    log-mel -> (B, T, 88). `uncond_mask` sets the log-mel of its rows to -1,
    the flagship's classifier-free contract."""

    def __init__(self, dim: int = 28, dim_mults=(1, 2, 4), convnext_mult: int = 2,
                 n_mels: int = 229, pitches: int = 88):
        super().__init__()
        init_dim, in_out = _levels(dim, dim_mults)
        self.n_levels = len(in_out)
        time_dim = 4 * dim

        def block(d_in, d_out, spec_in=None):
            return SpecConvNextBlock(d_in, spec_in or d_in, d_out, time_dim, convnext_mult,
                                     spec_dense_lift=spec_in is not None)

        self.init_conv = conv(1, init_dim, 7)
        self.spec_init_conv = conv(1, init_dim, 7)
        # the mel axis projected to the key axis, so the two streams align
        self.spec_init_fc = dense(n_mels, pitches)
        self.time_mlp = SinusoidalTimeEmbedding(dim)
        for i, (d_in, d_out) in enumerate(in_out):
            self.add_module(f"down_{i}_block1", block(d_in, d_out))
            self.add_module(f"down_{i}_block2", block(d_out, d_out))
            self.add_module(f"down_{i}_attn", PreNormResidual(d_out, LinearAttention(d_out)))
            if i < self.n_levels - 1:
                self.add_module(f"down_{i}_ds", Downsample(d_out))
                self.add_module(f"down_{i}_spec_ds", Downsample(d_out))
        width = in_out[-1][1]
        self.mid_block1 = block(width, width)
        self.mid_attn = PreNormResidual(width, Attention(width))
        self.mid_block2 = block(width, width)
        for i, (d_in, d_out) in enumerate(reversed(in_out[1:])):
            # x, its skip and the spectrogram's skip, concatenated
            self.add_module(f"up_{i}_block1", block(width + 2 * d_out, d_in, spec_in=width))
            self.add_module(f"up_{i}_block2", block(d_in, d_in))
            self.add_module(f"up_{i}_attn", PreNormResidual(d_in, LinearAttention(d_in)))
            self.add_module(f"up_{i}_us", upsample(d_in))
            self.add_module(f"up_{i}_spec_us", upsample(d_in))
            width = d_in
        self.final_block = block(width, dim)
        self.final_conv = conv(dim, 1, 1)

    def forward(self, x: torch.Tensor, t: torch.Tensor, cond: torch.Tensor,
                uncond_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if uncond_mask is not None:
            cond = torch.where(uncond_mask[:, None, None], torch.full_like(cond, -1.0), cond)
        m = self._modules
        x = self.init_conv(x[:, None])
        spec = self.spec_init_fc(self.spec_init_conv(cond[:, None]))  # (B, C, T, 88)
        t_emb = self.time_mlp(t)
        skips = []
        for i in range(self.n_levels):
            x, spec = m[f"down_{i}_block1"](x, spec, t_emb)
            x, spec = m[f"down_{i}_block2"](x, spec, t_emb)
            x = m[f"down_{i}_attn"](x)
            skips.append((x, spec))
            if i < self.n_levels - 1:
                with span("unet.resample"):
                    x, spec = m[f"down_{i}_ds"](x), m[f"down_{i}_spec_ds"](spec)
        x, spec = self.mid_block1(x, spec, t_emb)
        x, spec = self.mid_block2(self.mid_attn(x), spec, t_emb)
        for i in range(self.n_levels - 1):
            x_skip, spec_skip = skips.pop()
            x, spec = m[f"up_{i}_block1"](torch.cat([x, x_skip, spec_skip], dim=1), spec, t_emb)
            x, spec = m[f"up_{i}_block2"](x, spec, t_emb)
            x = m[f"up_{i}_attn"](x)
            with span("unet.resample"):
                x, spec = m[f"up_{i}_us"](x), m[f"up_{i}_spec_us"](spec)
        x, _ = self.final_block(x, spec, t_emb)
        return self.final_conv(x)[:, 0]
