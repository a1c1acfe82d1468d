"""The plain reference of SpecUnet, DiffRoll's spectrogram-conditioned U-Net
(sony/DiffRoll `model/unet.py`, `SpecUnet` and its blocks;
`config/model/SpecUnet.yaml`; arXiv 2210.05148), and of its `spec_roll`
training loss with gradients and one Adam update.

Plain PyTorch in float32, written from the published description and imported
by nothing of the program. On a card call `diffroll.exact_f32()` first.
Layouts: rolls and noise (B, T, 88) as the caller holds them; images
(B, C, T, 88); the log-mel (B, T, n_mels).

The network, at width `dim` (28) and multipliers (1, 2, 4):
  the roll and the log-mel each through a 7x7 conv (1 -> dim // 3 * 2); the
  log-mel's mel axis then projected to the 88 keys (Linear 229 -> 88);
  the step through a sinusoidal embedding (dim), Linear, GELU, Linear (4 dim);
  down, at each of three resolutions: two ConvNeXt blocks over both streams,
  a linear attention on x (pre-norm, residual), the skips (x and the
  spectrogram) kept, both streams halved by a 4x4 stride-2 conv (not after
  the last);
  the bottleneck: a block, full softmax attention on x, a block;
  up, at the two upper resolutions: x, its skip and the spectrogram's skip
  concatenated (three times the width) into a block whose spectrogram stream
  is lifted by a dense 7x7 conv, a block, a linear attention, both streams
  doubled by a 4x4 stride-2 transposed conv;
  a last block (its spectrogram output unused) and a 1x1 conv to one channel.
A ConvNeXt block over (x, spec): h = depthwise 7x7 (x) + s + a Linear of
GELU(step embedding), s = the spectrogram's depthwise (or lifting) 7x7;
x' = conv3x3(GN(GELU(conv3x3(GN(h))))) + x (a 1x1 conv of x where the width
changes), spec' = the same net with its own weights over s. GroupNorm has
one group. Attention has 4 heads of 32: linear attention softmaxes q over its
features and k over the positions and shares one k^T v context, then a 1x1
conv and a GroupNorm; full attention softmaxes q k^T / sqrt(32) over the
positions.

Departures from `model/unet.py`, each also the port's and the JAX
package's:
  * GroupNorm's epsilon is 1e-6 (flax's default), not PyTorch's 1e-5;
  * GELU is the tanh approximation (flax's default), not the exact erf;
  * each stream has its own down-sampler: the published forward passes the
    spectrogram through the x stream's and leaves its `spec_downsample`
    unused.

`precision="bf16"` is the benchmark's control: every operand of every
convolution, transposed convolution, Linear and attention product (inputs and
weights) rounded to bfloat16, and the gradients reaching them too, the step
below the TF32 convolutions and f32 products that the configuration states.
`precision="fp8"` rounds the same operands to float8 e4m3 with a per-tensor
scale, their gradients to e5m2. GroupNorm, the nonlinearities, the softmaxes
and the residual sums stay f32.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import diffroll as ref

GN_EPS = 1e-6
HEADS, DIM_HEAD = 4, 32


def conditioner(wave: torch.Tensor, cfg: dict) -> torch.Tensor:
    """(B, L) waveform -> (B, frames, n_mels): torchaudio's normalised power
    mel spectrogram (centred, reflect padding, periodic Hann) and
    log(. + 1e-6), not normalised (`spec_norm: "none"`), cut to `frames`."""
    mel = cfg["mel"]
    n_fft, hop = mel["n_fft"], mel["hop_length"]
    win = ref.hann_periodic(n_fft)
    window = torch.tensor(win, dtype=torch.float32, device=wave.device)
    spec = torch.stft(wave.float(), n_fft, hop_length=hop, window=window, center=True,
                      pad_mode="reflect", onesided=True, return_complex=True)
    power = spec.abs().square() / float(np.sum(win ** 2))        # (B, F, n_frames)
    fb = torch.tensor(ref.htk_mel_filters(n_fft, mel["sample_rate"], cfg["n_mels"],
                                          mel["f_min"], mel["f_max"]),
                      dtype=torch.float32, device=wave.device)
    return torch.log(power.transpose(1, 2) @ fb + 1e-6)[:, : cfg["frames"]]


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


class SpecUnet:
    """The SpecUnet net over a state dict of the port's parameter names
    (`net.` prefix; Conv2d (O, I/groups, kT, k88), ConvTranspose2d
    (I, O, 4, 4), Linear (O, I), GroupNorm weight and bias); read-only on
    it, or differentiable in it when its tensors require gradients."""

    def __init__(self, params: Dict[str, torch.Tensor], cfg: dict, precision: str = "f32"):
        self.p = {k[len("net."):] if k.startswith("net.") else k: v for k, v in params.items()}
        self.q = ref._quantizers(precision)[0]
        self.dim = cfg["residual_channels"]
        self.mults = tuple(cfg["dim_mults"])

    # ------------------------------------------------------------ layers
    def conv(self, name: str, x: torch.Tensor, groups: int = 1) -> torch.Tensor:
        """A stride-1 convolution padded to keep the size (odd kernels)."""
        w = self.p[name + ".weight"]
        return F.conv2d(self.q(x), self.q(w), self.p.get(name + ".bias"),
                        padding=w.shape[-1] // 2, groups=groups)

    def linear(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return F.linear(self.q(x), self.q(self.p[name + ".weight"]), self.p[name + ".bias"])

    def norm(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x, 1, self.p[name + ".weight"], self.p[name + ".bias"], GN_EPS)

    def down(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """Halve both axes: a 4x4 stride-2 conv, one position of padding a side."""
        return F.conv2d(self.q(x), self.q(self.p[name + ".weight"]), self.p[name + ".bias"],
                        stride=2, padding=1)

    def up(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """Double both axes: a 4x4 stride-2 transposed conv."""
        return F.conv_transpose2d(self.q(x), self.q(self.p[name + ".weight"]),
                                  self.p[name + ".bias"], stride=2, padding=1)

    # ------------------------------------------------------------ blocks
    def step_embedding(self, t: torch.Tensor) -> torch.Tensor:
        half = self.dim // 2
        freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                          * -(math.log(10000.0) / (half - 1)))
        ang = t.float()[:, None] * freqs[None]
        e = torch.cat([torch.sin(ang), torch.cos(ang)], -1)
        return self.linear("time_mlp.linear2", _gelu(self.linear("time_mlp.linear1", e)))

    def block(self, name: str, x: torch.Tensor, spec: torch.Tensor,
              emb: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """A ConvNeXt block over both streams; the spectrogram's 7x7 is
        depthwise where its width is x's input width, else a dense lift."""
        pre = name + "."
        h = self.conv(pre + "ds_conv", x, groups=x.shape[1])
        lift = self.p[pre + "spec_ds_conv.weight"].shape[1] != 1
        s = self.conv(pre + "spec_ds_conv", spec, groups=1 if lift else spec.shape[1])
        h = h + s + self.linear(pre + "time_mlp", _gelu(emb))[:, :, None, None]

        def net(z, stream):
            z = self.conv(pre + stream + "conv1", self.norm(pre + stream + "norm1", z))
            return self.conv(pre + stream + "conv2", self.norm(pre + stream + "norm2", _gelu(z)))

        res = x if pre + "res_conv.weight" not in self.p else self.conv(pre + "res_conv", x)
        return net(h, "net_") + res, net(s, "spec_net_")

    def _qkv(self, name: str, x: torch.Tensor):
        """(B, C, T, K) -> q, k, v, each (B, heads, T K, 32)."""
        b, _, h, w = x.shape
        qkv = F.conv2d(self.q(x), self.q(self.p[name + ".to_qkv.weight"]))
        return qkv.reshape(b, 3, HEADS, DIM_HEAD, h * w).transpose(-1, -2).unbind(1)

    def _merge(self, out: torch.Tensor, h: int, w: int) -> torch.Tensor:
        b = out.shape[0]
        return out.transpose(-1, -2).reshape(b, HEADS * DIM_HEAD, h, w)

    def linear_attention(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """x + LinearAttention(GroupNorm(x))."""
        q_, p = self.q, name + ".fn"
        q, k, v = self._qkv(p, self.norm(name + ".norm1", x))
        q = q.softmax(dim=-1) * DIM_HEAD ** -0.5
        k = k.softmax(dim=-2)
        context = torch.einsum("bhnd,bhne->bhde", q_(k), q_(v))
        out = torch.einsum("bhde,bhnd->bhne", q_(context), q_(q))
        out = self.conv(p + ".conv1", self._merge(out, *x.shape[-2:]))
        return x + self.norm(p + ".norm1", out)

    def attention(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """x + Attention(GroupNorm(x)): softmax over all positions."""
        q_, p = self.q, name + ".fn"
        q, k, v = self._qkv(p, self.norm(name + ".norm1", x))
        sim = torch.einsum("bhid,bhjd->bhij", q_(q * DIM_HEAD ** -0.5), q_(k))
        out = torch.einsum("bhij,bhjd->bhid", q_(sim.softmax(dim=-1)), q_(v))
        return x + self.conv(p + ".to_out", self._merge(out, *x.shape[-2:]))

    # ------------------------------------------------------------ the net
    def __call__(self, x_t: torch.Tensor, t: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        """x_t (B, T, 88), t (B,) int, cond (B, T, n_mels) -> the x0
        prediction (B, T, 88)."""
        levels = len(self.mults)
        x = self.conv("init_conv", x_t[:, None])
        spec = self.linear("spec_init_fc", self.conv("spec_init_conv", cond[:, None]))
        emb = self.step_embedding(t)
        skips = []
        for i in range(levels):
            x, spec = self.block(f"down_{i}_block1", x, spec, emb)
            x, spec = self.block(f"down_{i}_block2", x, spec, emb)
            x = self.linear_attention(f"down_{i}_attn", x)
            skips.append((x, spec))
            if i < levels - 1:
                x, spec = self.down(f"down_{i}_ds", x), self.down(f"down_{i}_spec_ds", spec)
        x, spec = self.block("mid_block1", x, spec, emb)
        x = self.attention("mid_attn", x)
        x, spec = self.block("mid_block2", x, spec, emb)
        for i in range(levels - 1):
            x_skip, spec_skip = skips.pop()
            x, spec = self.block(f"up_{i}_block1", torch.cat([x, x_skip, spec_skip], 1),
                                 spec, emb)
            x, spec = self.block(f"up_{i}_block2", x, spec, emb)
            x = self.linear_attention(f"up_{i}_attn", x)
            x, spec = self.up(f"up_{i}_us", x), self.up(f"up_{i}_spec_us", spec)
        x, _ = self.block("final_block", x, spec, emb)
        return self.conv("final_conv", x)[:, 0]


# ----------------------------------------------------------------- training

def train_loss(net: SpecUnet, cfg: dict, audio: torch.Tensor, frame: torch.Tensor,
               t: torch.Tensor, noise: torch.Tensor,
               keep: Optional[dict] = None) -> torch.Tensor:
    """The `spec_roll` x0 objective on the raw roll (`norm_args` mode
    "none"): x_t = sqrt(acum[t]) roll + sqrt(1 - acum[t]) noise, the mean
    squared error of the net's x0 prediction from it, conditioned on the
    audio's log-mel. With `keep`, `keep["pred"]` holds the prediction."""
    sch = ref.schedule(cfg)
    dev = frame.device
    roll = frame.float()
    sac = torch.tensor(sch["sac"], dtype=torch.float32, device=dev)[t][:, None, None]
    s1m = torch.tensor(sch["s1m"], dtype=torch.float32, device=dev)[t][:, None, None]
    pred = net(sac * roll + s1m * noise, t, conditioner(audio, cfg))
    if keep is not None:
        keep["pred"] = pred.detach()
    return torch.mean((roll - pred) ** 2)
