"""The plain reference of DiffRoll (arXiv 2210.05148; sony/DiffRoll): the log-mel
front end, the min-max normalisation, the 1-D gated dilated-conv denoiser, the
DDPM schedule, the x0-parameterised ancestral sampler with classifier-free
guidance, the long-audio windowing and crossfade, the note decoder, and the
training loss with its gradients and one Adam update.

Plain PyTorch in float32, written from the published description and imported
by nothing of the program. On a card every product runs in true f32: call
`exact_f32()` first (TF32 off for matmuls and cuDNN convolutions).

`precision="fp8"` is the benchmark's control: every operand of the gated
stack's products (weights, the layer inputs, the conditioner, the gated
activations) and the residual stream between layers are rounded to float8
e4m3 with a per-tensor scale, the step below the bf16 operands that the
configurations state; in training the gradients reaching those products are
rounded to e5m2. The heads, the skip sums and the sampler state stay f32.

`precision="bf16"` is the second control, the step below the f32 that the
configurations state for the rest: the gated stack's operands and residual
stream rounded to bfloat16 as the configurations state, and besides every
operand and output of the heads (the input projection, the step embedding
and its per-layer projections, the skip and output projections), the skip
sums and the sampler's state, rounded to bfloat16 too; in training the
gradients reaching them as well.

Layouts: activations (B, C, T); rolls and noise as the caller holds them,
(B, T, 88); the conditioner (B, T, n_mels).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

SQRT_HALF = 1.0 / math.sqrt(2.0)
PRECISIONS = ("f32", "fp8", "bf16")
FP8_MAX = 448.0       # the largest float8 e4m3 value
FP8_GRAD_MAX = 57344.0  # the largest float8 e5m2 value


def exact_f32() -> None:
    """Products in full float32 on a card (TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _round_fp8(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    amax = x.detach().abs().amax().float().clamp_min(1e-30)
    scale = top / amax
    return (x.float() * scale).to(dtype).float() / scale


class _Fp8(torch.autograd.Function):
    """Forward: round to e4m3; backward: round the gradient to e5m2."""

    @staticmethod
    def forward(ctx, x):
        return _round_fp8(x, torch.float8_e4m3fn, FP8_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round_fp8(g, torch.float8_e5m2, FP8_GRAD_MAX)


class _Bf16(torch.autograd.Function):
    """Forward and backward: round to bfloat16."""

    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).float()

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).float()


def _same(x):
    return x


def _quantizers(precision: str):
    """The rounding of the gated stack's operands and of the rest (heads,
    skip sums, sampler state)."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r}; choices: {PRECISIONS}")
    if precision == "fp8":
        return _Fp8.apply, _same
    if precision == "bf16":
        return _Bf16.apply, _Bf16.apply
    return _same, _same


# ----------------------------------------------------------------- front end

def hann_periodic(n: int) -> np.ndarray:
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)


def htk_mel_filters(n_fft: int, sample_rate: int, n_mels: int, f_min: float,
                    f_max: float) -> np.ndarray:
    """(n_fft // 2 + 1, n_mels) triangular HTK filters without area norm."""
    def to_mel(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)

    freqs = np.linspace(0.0, sample_rate / 2.0, n_fft // 2 + 1)
    edges = 700.0 * (10.0 ** (np.linspace(to_mel(f_min), to_mel(f_max), n_mels + 2)
                              / 2595.0) - 1.0)
    lo, mid, hi = edges[:-2], edges[1:-1], edges[2:]
    rise = (freqs[:, None] - lo[None]) / (mid - lo)[None]
    fall = (hi[None] - freqs[:, None]) / (hi - mid)[None]
    return np.maximum(0.0, np.minimum(rise, fall))


def min_max(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """Per-sample min-max over every non-batch element to [lo, hi]; a
    constant sample maps to lo."""
    dims = tuple(range(1, x.ndim))
    x_min = x.amin(dim=dims, keepdim=True)
    x_max = x.amax(dim=dims, keepdim=True)
    span = x_max - x_min
    out = (x - x_min) / torch.where(span > 0, span, torch.ones_like(span)) * (hi - lo) + lo
    return torch.where(span > 0, out, torch.full_like(x, lo))


def conditioner(wave: torch.Tensor, cfg: dict) -> torch.Tensor:
    """(B, L) waveform -> (B, frames, n_mels): torchaudio's normalised power
    mel spectrogram (centred, reflect padding, periodic Hann), log(. + 1e-6),
    min-max over the whole (n_frames, n_mels) image, cut to `frames`."""
    mel = cfg["mel"]
    n_fft, hop = mel["n_fft"], mel["hop_length"]
    win = hann_periodic(n_fft)
    window = torch.tensor(win, dtype=torch.float32, device=wave.device)
    spec = torch.stft(wave.float(), n_fft, hop_length=hop, window=window, center=True,
                      pad_mode="reflect", onesided=True, return_complex=True)
    power = spec.abs().square() / float(np.sum(win ** 2))        # (B, F, n_frames)
    fb = torch.tensor(htk_mel_filters(n_fft, mel["sample_rate"], cfg["n_mels"],
                                      mel["f_min"], mel["f_max"]),
                      dtype=torch.float32, device=wave.device)
    logmel = torch.log(power.transpose(1, 2) @ fb + 1e-6)       # (B, n_frames, n_mels)
    lo, hi = spec_range(cfg)
    return min_max(logmel, lo, hi)[:, : cfg["frames"]]


def spec_range(cfg: dict):
    """The conditioner's min-max range: [0, 1] for spec_norm 'unit', the
    roll's `norm_args` range for 'norm_args'."""
    if cfg["spec_norm"] == "unit":
        return 0.0, 1.0
    if cfg["spec_norm"] == "norm_args":
        return float(cfg["norm_args"][0]), float(cfg["norm_args"][1])
    raise ValueError(f"spec_norm {cfg['spec_norm']!r} is not covered")


def guided(cfg: dict) -> bool:
    """Classifier-free guided sampling (the `cfdg_` samplers)."""
    return cfg["sampling_type"].startswith("cfdg_")


# ----------------------------------------------------------------- denoiser

def step_table(max_steps: int, dim: int = 128) -> torch.Tensor:
    """DiffWave's sinusoidal step table: sin and cos of t * 10^(4 i / 63)."""
    half = dim // 2
    ang = np.arange(max_steps)[:, None] * 10.0 ** (np.arange(half)[None] * 4.0 / (half - 1))
    return torch.tensor(np.concatenate([np.sin(ang), np.cos(ang)], 1), dtype=torch.float32)


def dilations(cfg: dict) -> List[int]:
    return [cfg["dilation_base"] ** (i % cfg["dilation_bound"])
            for i in range(cfg["residual_layers"])]


class Denoiser:
    """The DiffRoll net over a state dict of the published parameter names
    (`net.` prefix, Conv1d (O, I, K), Linear (O, I)); read-only on it, or
    differentiable in it when its tensors require gradients."""

    def __init__(self, params: Dict[str, torch.Tensor], cfg: dict, precision: str = "f32"):
        self.p = {k[len("net."):] if k.startswith("net.") else k: v for k, v in params.items()}
        self.cfg = cfg
        self.q, self.qh = _quantizers(precision)
        self.dil = dilations(cfg)
        self.table = step_table(cfg["timesteps"]).to(self.p["input_projection.weight"].device)

    def step_embedding(self, t: torch.Tensor) -> torch.Tensor:
        qh, p = self.qh, self.p
        e = self.table[t]
        e = F.silu(F.linear(qh(e), qh(p["diffusion_embedding.projection1.weight"]),
                            p["diffusion_embedding.projection1.bias"]))
        return qh(F.silu(F.linear(qh(e), qh(p["diffusion_embedding.projection2.weight"]),
                                  p["diffusion_embedding.projection2.bias"])))

    def cond_terms(self, cond: torch.Tensor) -> List[torch.Tensor]:
        """(B, T, n_mels) -> every layer's projected conditioner (B, 2C, T)."""
        q, p = self.q, self.p
        c = q(cond.transpose(1, 2))
        return [F.conv1d(c, q(p[f"residual_layers.{i}.conditioner_projection.weight"]),
                         p[f"residual_layers.{i}.conditioner_projection.bias"])
                for i in range(len(self.dil))]

    def __call__(self, x_t: torch.Tensor, t: torch.Tensor,
                 cond_terms: Optional[Sequence[torch.Tensor]]) -> torch.Tensor:
        """x_t (B, T, 88), t (B,) int -> the prediction (B, T, 88)."""
        q, qh, p = self.q, self.qh, self.p
        h = qh(F.relu(F.conv1d(qh(x_t.transpose(1, 2)), qh(p["input_projection.weight"]),
                               p["input_projection.bias"])))
        emb = self.step_embedding(t)
        ch = h.shape[1]
        skip = torch.zeros_like(h)
        for i, d in enumerate(self.dil):
            pre = f"residual_layers.{i}."
            bias = qh(F.linear(emb, qh(p[pre + "diffusion_projection.weight"]),
                               p[pre + "diffusion_projection.bias"]))
            a = F.conv1d(q(h + bias[:, :, None]), q(p[pre + "dilated_conv.weight"]),
                         p[pre + "dilated_conv.bias"], padding=d, dilation=d)
            if cond_terms is not None:
                a = a + cond_terms[i]
            g = torch.sigmoid(a[:, :ch]) * torch.tanh(a[:, ch:])
            out = F.conv1d(q(g), q(p[pre + "output_projection.weight"]),
                           p[pre + "output_projection.bias"])
            h = q((h + out[:, :ch]) * SQRT_HALF)
            skip = qh(skip + out[:, ch:])
        skip = qh(skip / math.sqrt(len(self.dil)))
        hid = qh(F.relu(F.conv1d(skip, qh(p["skip_projection.weight"]),
                                 p["skip_projection.bias"])))
        y = qh(F.conv1d(hid, qh(p["output_projection.weight"]), p["output_projection.bias"]))
        return y.transpose(1, 2)


# ----------------------------------------------------------------- diffusion

def schedule(cfg: dict) -> Dict[str, np.ndarray]:
    """The linear beta schedule's square roots, in float64."""
    betas = np.linspace(cfg["beta_start"], cfg["beta_end"], cfg["timesteps"])
    acum = np.cumprod(1.0 - betas)
    return {"sac": np.sqrt(acum), "s1m": np.sqrt(1.0 - acum)}


def sample(net: Denoiser, cfg: dict, x_T: torch.Tensor, noise: torch.Tensor,
           cond: torch.Tensor) -> torch.Tensor:
    """The ancestral x0 sampler over t = T-1 .. 0: x_{t-1} = sqrt(acum[t-1]) x0
    + c (x_t - sqrt(acum[t]) x0) / sqrt(1 - acum[t]) + sigma noise, with
    sigma^2 the posterior variance and c^2 = 1 - acum[t-1] - sigma^2; the last
    step returns x0 / sqrt(acum[0]). Guided (`guided(cfg)`): x0 = (1 + w)
    x0(spec) - w x0(spec := -1). x_T (B, T, 88); noise (T, B, T, 88)."""
    sch = schedule(cfg)
    sac, s1m = sch["sac"], sch["s1m"]
    cfg_guided, w = guided(cfg), float(cfg["w"])
    b = x_T.shape[0]
    terms = net.cond_terms(cond)
    if cfg_guided:
        unc = net.cond_terms(torch.full_like(cond, -1.0))
        terms = [torch.cat([c, u]) for c, u in zip(terms, unc)]
    qh = net.qh
    x = qh(x_T.float())
    n = cfg["timesteps"]
    for s, t in enumerate(range(n - 1, -1, -1)):
        tv = torch.full((2 * b if cfg_guided else b,), t, dtype=torch.long, device=x.device)
        if cfg_guided:
            both = net(torch.cat([x, x]), tv, terms)
            x0 = qh((1.0 + w) * both[:b] - w * both[b:])
        else:
            x0 = net(x, tv, terms)
        if t == 0:
            x = qh(x0 / float(sac[0]))
            break
        tp = t - 1
        sigma = s1m[tp] / s1m[t] * math.sqrt(max(1.0 - (sac[t] / sac[tp]) ** 2, 0.0))
        c_dir = math.sqrt(max(1.0 - sac[tp] ** 2 - sigma ** 2, 0.0))
        x = qh(float(sac[tp]) * x0 + float(c_dir / s1m[t]) * (x - float(sac[t]) * x0)
               + float(sigma) * noise[s])
    return x


# ----------------------------------------------------------------- long audio

def windows(audio: np.ndarray, seq_len: int, stride: int) -> np.ndarray:
    """(L,) -> (n, seq_len): windows every `stride` samples covering L, the
    last zero-padded; at least one."""
    n = max(1, -(-max(len(audio) - seq_len, 0) // stride) + 1)
    out = np.zeros((n, seq_len), np.float32)
    for i in range(n):
        part = audio[i * stride: i * stride + seq_len]
        out[i, : len(part)] = part
    return out


def stitch(rolls: np.ndarray, overlap: int, total: int) -> np.ndarray:
    """(n, F, 88) -> (total, 88): overlapped frames crossfaded linearly with
    weights k / (overlap + 1), k = 1 .. overlap."""
    n, frames, _ = rolls.shape
    stride = frames - overlap
    weight = np.ones(frames)
    if overlap:
        ramp = np.arange(1, overlap + 1) / (overlap + 1)
        weight[:overlap], weight[frames - overlap:] = ramp, ramp[::-1]
    length = max(total, (n - 1) * stride + frames)
    acc, wsum = np.zeros((length, rolls.shape[2])), np.zeros(length)
    for i in range(n):
        acc[i * stride: i * stride + frames] += rolls[i] * weight[:, None]
        wsum[i * stride: i * stride + frames] += weight
    return (acc / np.maximum(wsum, 1e-8)[:, None])[:total]


def notes(roll: np.ndarray, threshold: float) -> np.ndarray:
    """Each maximal run of frames above `threshold` on one key is a note:
    (N, 3) rows of (key, first frame, end frame), by first frame then key."""
    on = np.asarray(roll) > threshold
    edge = np.diff(np.pad(on, ((1, 1), (0, 0))).astype(np.int8), axis=0)
    starts, keys = np.nonzero(edge == 1)
    ends, keys_end = np.nonzero(edge == -1)
    order_s, order_e = np.lexsort((starts, keys)), np.lexsort((ends, keys_end))
    rows = np.stack([keys[order_s], starts[order_s], ends[order_e]], 1)
    return rows[np.lexsort((rows[:, 0], rows[:, 1]))].astype(np.int64)


# ----------------------------------------------------------------- training

def train_loss(net: Denoiser, cfg: dict, audio: torch.Tensor, frame: torch.Tensor,
               t: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """The x0 objective: the roll min-maxed to the `norm_args` range, noised to x_t =
    sqrt(acum[t]) x0 + sqrt(1 - acum[t]) noise, and the mean squared error of
    the denoiser's x0 prediction from it, conditioned on the audio's mel."""
    sch = schedule(cfg)
    dev = frame.device
    roll = min_max(frame.float(), float(cfg["norm_args"][0]), float(cfg["norm_args"][1]))
    sac = torch.tensor(sch["sac"], dtype=torch.float32, device=dev)[t][:, None, None]
    s1m = torch.tensor(sch["s1m"], dtype=torch.float32, device=dev)[t][:, None, None]
    x_t = sac * roll + s1m * noise
    cond = conditioner(audio, cfg)
    pred = net(x_t, t, net.cond_terms(cond))
    return torch.mean((roll - pred) ** 2)


def adam_update(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
                state: Dict[str, Tuple[torch.Tensor, torch.Tensor]], step: int,
                lr: float, betas=(0.9, 0.999), eps: float = 1e-8) -> None:
    """One Adam step (no weight decay) in place on `params` and `state`."""
    b1, b2 = betas
    for k, g in grads.items():
        m, v = state.get(k, (torch.zeros_like(g), torch.zeros_like(g)))
        m = b1 * m + (1.0 - b1) * g
        v = b2 * v + (1.0 - b2) * g * g
        state[k] = (m, v)
        m_hat = m / (1.0 - b1 ** step)
        v_hat = v / (1.0 - b2 ** step)
        params[k] -= lr * m_hat / (torch.sqrt(v_hat) + eps)
