"""Offline transcription with SpecUnet on the port's guided path: recordings
one after another through `transcribe_long`, whose `DiffusionTask.sample`
computes the spectrogram stream once a batch for both guidance branches
(`cfg_cond_projections`) and runs the x stream on 2B rows every one of the
T reverse steps (`apply_cfg(..., cond_proj=)`), with PyTorch's default
precision (cuDNN convolutions in TF32, products in f32); then the port's
note decoding.

As `runners/transcribe.py` (the recordings, their seeded order, the draws,
the check's sample of batches and its two numbers), with the weights of
`weights_unet.py` and these differences:
  * the window transcribes whole cycles of the seeded order, every recording
    of the mix once a cycle, until its deadline has passed: at least one
    cycle, whatever `seconds`. Every seed gets the same recordings, so every
    window does the same work, batches of every size the mix gives included,
    and windows_per_s reads the whole mix's rate; a window cut at a time
    would hold one or two recordings of a cycle, and which ones would set
    the rate;
  * set-up first reads the program's count of rows through the spectrogram
    stream (`diffroll_tpu_torch.nn.unet.spec_rows`) and stops where the
    program has none; it then warms every batch size the mix produces
    through the same `transcribe_long` path with a task whose reverse
    process is cut to `WARM_STEPS` steps: the same shapes and kernels
    without 200 steps a size;
  * the traced stretch is the window's first full batch, one whole
    `DiffusionTask.sample` call of `batch_size` windows, and keeps the
    card's side of the program's spans (`trace_annotated.py`);
  * the window records the rows through the spectrogram stream
    (`unet.spec_rows`) and no K2 launches, which this model has none of;
  * the reference is `reference/spec_unet_sample.py`: the whole net on both
    branches every step, in f32 with TF32 off; with `control`, also in bf16
    over the sample's first batch, a full one (`control_bf16.roll_rms`, the
    bf16 reference read in the program's place: a reading above the limit
    there fails the whole sample), and TF32 is the process's own again
    after the check.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from .. import inputs, port, trace, trace_annotated, weights_unet
from ..reference import diffroll as ref
from ..reference import spec_unet as uref
from ..reference import spec_unet_sample as sref
from . import train_unet, transcribe
from .transcribe import MAX_CYCLES, WEIGHT_STREAM, batch_sizes

WARM_STEPS = 2


def spec_rows() -> Optional[int]:
    """Rows through SpecUnet's spectrogram stream so far; None where the
    program does not count them."""
    from diffroll_tpu_torch.nn import unet

    return getattr(unet, "spec_rows", None)


class Runner(transcribe.Runner):
    def __init__(self, run):
        super().__init__(run)
        self.wants: Dict[tuple, np.ndarray] = {}

    # ------------------------------------------------------------ phases
    def setup(self) -> None:
        if spec_rows() is None:
            raise RuntimeError("the program does not count the rows through SpecUnet's "
                               "spectrogram stream (diffroll_tpu_torch.nn.unet.spec_rows)")
        run = self.run
        cfg, mix, dev = run.cfg, run.mix, run.device
        self.params = weights_unet.make(cfg, inputs.torch_seed(run.seed, WEIGHT_STREAM), dev)
        model = port.build_model(cfg, dev, self.params).eval()
        run.mark("model")
        self.audio = inputs.recordings(mix, run.seed, self.sr, dev)
        run.mark("inputs")
        sizes = sorted({b for a in self.audio
                        for b in batch_sizes(self.windows_of(a), mix["batch_size"])})
        longest = max(self.audio, key=len)
        self.task = port.build_task(cfg, model, sampling_steps=WARM_STEPS)
        for b in sizes:
            cut = longest[: self.seq_len + (b - 1) * self.stride]
            self.decode(self.transcribe(cut, torch.Generator(device=dev).manual_seed(b)))
        self.task = port.build_task(cfg, model)

    def window(self, seconds: float, traced: bool) -> dict:
        """Whole cycles of the seeded order until the deadline has passed, at
        least one; with `traced`, the first `DiffusionTask.sample` call of a
        full batch profiled."""
        run, mix = self.run, self.run.mix
        prof: dict = {}
        if traced:
            sample, size = self.task.sample, mix["batch_size"]

            def traced_sample(x_T, *args, **kw):
                if "trace" in prof or x_T.shape[0] != size:
                    return sample(x_T, *args, **kw)
                with trace_annotated.stretch(prof):
                    return sample(x_T, *args, **kw)

            self.task.sample = traced_sample
        count = mix["recordings"]["count"]
        order = inputs.recording_order(mix, run.seed, cycles=MAX_CYCLES)
        done, before = [], spec_rows()
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while not done or len(done) % count or (
                time.perf_counter() < deadline and len(done) < len(order)):
            i = len(done)
            audio = self.audio[order[i]]
            with trace.annotate("bench.transcribe_long"):
                roll = self.transcribe(audio, self.generator(i))
            with trace.annotate("bench.decode"):
                found = self.decode(roll)
            done.append({"i": i, "recording": order[i], "windows": self.windows_of(audio),
                         "roll": roll, "notes": found})
        out = {"elapsed_s": time.perf_counter() - t0, "recordings": done,
               "windows": sum(r["windows"] for r in done), "attempted": len(done),
               "failed": 0, "unet.spec_rows": spec_rows() - before}
        if "trace" in prof:
            out["trace"], out["traced_windows"] = prof["trace"], [mix["batch_size"]]
        return out

    # ------------------------------------------------------------ the check
    def reference_batch(self, audio: np.ndarray, generator: torch.Generator, k: int,
                        precision: str = "f32") -> np.ndarray:
        """As `transcribe.Runner.reference_batch`, through
        `reference/spec_unet_sample.py`."""
        cfg, mix, dev = self.run.cfg, self.run.mix, self.run.device
        size = mix["batch_size"]
        wins = ref.windows(audio, self.seq_len, self.stride)
        for j, b in enumerate(batch_sizes(len(wins), size)):
            shape = (b, cfg["frames"], cfg["pitches"])
            x_T = torch.randn(shape, generator=generator, device=dev)
            noise = torch.randn((cfg["timesteps"],) + shape, generator=generator, device=dev)
            if j == k:
                break
        chunk = torch.from_numpy(wins[k * size: k * size + b]).to(dev)
        with torch.no_grad():
            return sref.sample(self.params, cfg, x_T, noise, uref.conditioner(chunk, cfg),
                               precision).cpu().numpy()

    def batch_gap(self, r: dict, k: int, precision: str = "f32",
                  want: Optional[np.ndarray] = None):
        """`transcribe.Runner.batch_gap`, keeping the f32 reference's frames
        for the control."""
        gap, local = super().batch_gap(r, k, precision, want)
        if want is None:
            self.wants[(r["i"], k)] = local
        return gap, local

    def check(self, records: dict, control: bool = False) -> Dict[str, float]:
        """`roll_rms` and `notes_differ`; with `control`, the bf16 reference's
        `roll_rms` over the sample's first batch as `control_bf16.roll_rms`."""
        with train_unet.tf32(False):
            out = super().check(records)
            if control:
                r, k = self.sample(records)[0]
                out["control_bf16.roll_rms"] = self.batch_gap(r, k, "bf16",
                                                              self.wants[(r["i"], k)])[0]
        for k in ("unet.spec_rows", "windows"):
            out[k] = records[k]
        return out
