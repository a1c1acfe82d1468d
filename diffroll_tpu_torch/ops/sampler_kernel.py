"""The whole reverse-diffusion process (counterpart of
`diffroll_tpu/ops/sampler_kernel.py`).

Every reference sampler step is linear in (prediction, x, noise):
    x <- a[s] * pred + b[s] * x + sigma[s] * noise[s]
with per-step scalars from `sampler_tables`, which covers the x0- and
epsilon-parameterised samplers and their final-step branches. The
per-step FiLM biases t_bias (n, L, C) are computed by the caller.

`fused_sample` launches the CUDA kernels (csrc/sampler.cu, reusing K1's
device code) for CUDA tensors, with one call into the library per reverse
process: the step loop runs in C (`drk_sample_run`), as n replays of one
captured step. For CPU tensors it runs `fused_sample_ref`, the plain PyTorch
version.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import numpy as np
import torch

from ..diffusion.samplers import cfg_mix
from . import _build
from .fused_forward import HeadWeights, head_stack, head_weights
from .gated_stack import (
    GatedStackWeights,
    KernelWeights,
    _check,
    check_kernel_shapes,
    dilation_array,
    gated_stack,
    gated_stack_ref,
    pad_cond,
)

__all__ = ["HeadWeights", "head_weights", "sampler_tables", "fused_sample",
           "fused_sample_ref"]


def sampler_tables(schedule, sampler_type: str, ts: np.ndarray,
                   ts_prev: np.ndarray) -> np.ndarray:
    """Per-step (a, b, sigma) for `x <- a*pred + b*x + sigma*noise`, shape
    (n, 3) float32, evaluated in float64."""
    sac = np.asarray(schedule.sqrt_alphas_cumprod, np.float64)
    s1m = np.asarray(schedule.sqrt_one_minus_alphas_cumprod, np.float64)
    src = np.asarray(schedule.sqrt_recip_alphas, np.float64)
    betas = np.asarray(schedule.betas, np.float64)

    t = np.asarray(ts, np.int64)
    tp_raw = np.asarray(ts_prev, np.int64)
    done = tp_raw < 0
    tp = np.maximum(tp_raw, 0)

    alpha_ratio = (sac[t] / sac[tp]) ** 2
    sigma_ddpm = (s1m[tp] / s1m[t]) * np.sqrt(np.maximum(1.0 - alpha_ratio, 0.0))

    base = sampler_type[5:] if sampler_type.startswith("cfdg_") else sampler_type
    for prefix in ("generation_", "inpainting_"):
        if base.startswith(prefix):
            base = base[len(prefix):]

    if base in ("ddpm_x0", "ddim_x0"):
        sigma = sigma_ddpm if base == "ddpm_x0" else np.zeros_like(sigma_ddpm)
        c_dir = np.sqrt(np.maximum(1.0 - sac[tp] ** 2 - sigma ** 2, 0.0)) / s1m[t]
        a = sac[tp] - c_dir * sac[t]
        b = c_dir
        s = sigma
        a_done, b_done = 1.0 / sac[0], 0.0
    elif base in ("ddpm", "ddim", "ddim2ddpm"):
        # epsilon parameterisation: x0 = (x - s1m[t] eps) / sac[t]
        sigma = np.zeros_like(sigma_ddpm) if base == "ddim" else sigma_ddpm
        if base == "ddim":
            c_eps = s1m[tp]
        else:
            c_eps = np.sqrt(np.maximum(1.0 - sac[tp] ** 2 - sigma ** 2, 0.0))
        b = sac[tp] / sac[t]
        a = c_eps - b * s1m[t]
        s = sigma
        if base == "ddpm":
            # the reference's t==0 branch: deterministic posterior mean
            a_done = -src[t[-1]] * betas[t[-1]] / s1m[t[-1]]
            b_done = src[t[-1]]
        else:
            # x0 recovery at the final visited t
            a_done = -s1m[t[-1]] / sac[t[-1]]
            b_done = 1.0 / sac[t[-1]]
    else:
        raise KeyError(f"no linear tables for sampler {sampler_type!r}")

    a = np.where(done, a_done, a)
    b = np.where(done, b_done, b)
    s = np.where(done, 0.0, s)
    return np.stack([a, b, s], axis=1).astype(np.float32)


def _streams(cond: torch.Tensor, guided: bool) -> torch.Tensor:
    """Guided: the conditional rows, then the same count of spec := -1 rows."""
    return torch.cat([cond, torch.full_like(cond, -1.0)]) if guided else cond


def fused_sample_ref(
    x_T: torch.Tensor,
    noise: Optional[torch.Tensor],
    t_bias: torch.Tensor,
    tables: torch.Tensor,
    w: GatedStackWeights,
    head: HeadWeights,
    cond: Optional[torch.Tensor],
    dilations: Sequence[int],
    guided: bool,
    w_guidance: float = 0.0,
    stochastic: bool = True,
) -> torch.Tensor:
    """The plain version: per step, the f32 forward (head, `gated_stack_ref`,
    head) over both streams, the guidance mix and the table update."""
    x = x_T.float()
    b = x.shape[0]
    cond_in = None if cond is None else _streams(cond.float(), guided)
    for s in range(tables.shape[0]):
        xin = torch.cat([x, x]) if guided else x
        tb = t_bias[s][:, None, :].expand(-1, xin.shape[0], -1)
        pred = head_stack(xin, tb, cond_in, w, head, dilations, stack=gated_stack_ref)
        if guided:
            pred = cfg_mix(pred[:b], pred[b:], w_guidance)
        a, bb, sg = (float(v) for v in tables[s])
        x = a * pred + bb * x
        if stochastic:
            x = x + sg * noise[s]
    return x


def fused_sample(
    x_T: torch.Tensor,
    noise: Optional[torch.Tensor],
    t_bias: torch.Tensor,
    tables: torch.Tensor,
    w: GatedStackWeights,
    head: HeadWeights,
    cond: Optional[torch.Tensor],
    dilations: Sequence[int],
    guided: bool,
    w_guidance: float = 0.0,
    stochastic: bool = True,
    kweights: Optional[KernelWeights] = None,
) -> torch.Tensor:
    """Run the whole reverse process; returns x_0 (B, T, 88) f32.

    x_T (B, T, 88); noise (n, B, T, 88), or None when `stochastic` is
    False; t_bias (n, L, C); tables (n, 3); cond (B, T, M) the conditional
    branch's conditioner, or None. CPU tensors run `fused_sample_ref` on
    `w`; CUDA tensors launch the kernels on `kweights` (`kernel_weights(w)`,
    prepared once per model) or raise.
    """
    if not x_T.is_cuda:
        return fused_sample_ref(x_T, noise, t_bias, tables, w, head, cond,
                                dilations, guided, w_guidance, stochastic)
    if kweights is None:
        raise ValueError("the CUDA sampler takes `kweights` (kernel_weights(w), "
                         "prepared once per model)")
    lib = _build.library()
    kw = kweights
    dev = x_T.device
    bsz, t_len, n_out = x_T.shape
    n_layers, c = kw.wo.shape[0], kw.wo.shape[1]
    n = tables.shape[0]
    check_kernel_shapes(kw, c, n_layers, dev)
    conditional = cond is not None and kw.mp > 0
    if guided and not conditional:
        raise ValueError("guided sampling needs a conditioner")
    streams = 2 if guided else 1
    rows = bsz * t_len
    m = streams * rows

    x = x_T.float().contiguous().clone()  # updated in place into x_0
    tb = t_bias.float().contiguous()
    tb_ptr = _check(tb, "t_bias", torch.float32, (n, n_layers, c), dev)
    tab = tables.float().to(dev).contiguous()
    _check(tab, "tables", torch.float32, (n, 3), dev)
    noise_ptr = None
    if stochastic:
        noise = noise.float().contiguous()
        noise_ptr = _check(noise, "noise", torch.float32, (n, bsz, t_len, n_out), dev)
    hw = [v.float().contiguous() for v in head]
    for v, name, shape in zip(hw, HeadWeights._fields,
                              [(n_out, c), (c,), (c, c), (c,), (c, n_out), (n_out,)]):
        _check(v, name, torch.float32, shape, dev)
    win, bin_, wskip, bskip, wout, bout = (v.data_ptr() for v in hw)

    xbuf = torch.empty(m, c, device=dev, dtype=torch.bfloat16)
    scratch = torch.empty(2, m, c, device=dev, dtype=torch.bfloat16)
    skip = torch.empty(2, m, c, device=dev, dtype=torch.float32)  # skip sums, head hidden
    stream = torch.cuda.current_stream().cuda_stream
    if conditional:
        cond_p = pad_cond(_streams(cond.float(), guided), kw.mp).to(torch.bfloat16)
        cond_p = cond_p.contiguous()
        _check(cond_p, "cond", torch.bfloat16, (streams * bsz, t_len, kw.mp), dev)
        hoisted = torch.empty(n_layers, m, 2 * c, device=dev, dtype=torch.float32)
        _build.check(lib.drk_cond_proj(
            cond_p.data_ptr(), kw.mp, kw.wcat.data_ptr(), kw.wcat.shape[1],
            kw.taps * c, kw.b_eff.data_ptr(), hoisted.data_ptr(), n_layers, m, c,
            stream), "cond_proj")
        rowbias_ptr, colbias_ptr = hoisted.data_ptr(), None
    else:
        rowbias_ptr, colbias_ptr = None, kw.b.data_ptr()
    dil = dilation_array(dilations)
    passes = ctypes.c_int(0)
    step = torch.empty(1, device=dev, dtype=torch.int32)  # the device's step counter
    _build.check(lib.drk_sample_run(
        x.data_ptr(), noise_ptr, tab.data_ptr(), n, tb_ptr, win, bin_, wskip, bskip, wout,
        bout, float(w_guidance), xbuf.data_ptr(), skip[0].data_ptr(), scratch[0].data_ptr(),
        scratch[1].data_ptr(), skip[1].data_ptr(), kw.wcat.data_ptr(), kw.wcat.shape[1],
        colbias_ptr, rowbias_ptr, kw.wo.data_ptr(), kw.bo.data_ptr(), ctypes.addressof(dil),
        n_layers, rows, t_len, n_out, c, streams, kw.taps, step.data_ptr(), stream,
        ctypes.addressof(passes)), "sample_run")
    gated_stack.launches += passes.value
    fused_sample.launches += 1
    return x


fused_sample.launches = 0  # reverse processes launched on the card
