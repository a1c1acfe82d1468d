"""Profiling helpers (counterpart of `diffroll_tpu/utils/profiling.py`):
`trace_if` wraps a window of training steps in a `torch.profiler` trace
(a chrome trace under `log_dir`); `span` names a stage of the host's work in
whatever `torch.profiler` profile is recording; `StepTimer` keeps a cheap
host-side steps/sec + examples/sec counter for the metrics stream.

The spans, each a `user_annotation` in the profile's chrome trace, on the
same clock as the card's kernels and copies:

  transcribe.long       tasks/transcribe.py::transcribe_long, the whole call
  transcribe.split      its resampling and `split_windows`
  transcribe.copy_in    a batch's windows to the device (args: batch index)
  transcribe.draw       a batch's x_T
  transcribe.copy_out   a batch's rolls to the host
  transcribe.stitch     `stitch_rolls`
  sample                tasks/diffusion.py::DiffusionTask.sample
  sample.draw           its per-step noise
  sample.k2             the whole-process sampler's host preparation and
                        its C call (`_sample_megakernel`)
  conditioner           models/base.py::DiffRollModel.conditioner
  train.step            train/step.py, one training step
  train.zero_grad       its `zero_grad`
  train.loss            its loss (the forward)
  train.backward        its `backward`
  train.allreduce       the gradients' average over the data axis (a mesh only)
  train.optimizer       the optimizer's step
  train.data            train/loop.py::fit, the next batch fetched and moved
                        to the device
  serve.request         serve/service.py, a caller's request (args: its id)
  serve.gather          the dispatcher: the first window to the batch closed
                        (args: the batch's ordinal)
  serve.assemble        the waveform batch assembled and pinned
  serve.copy_in         the batch to the device
  serve.issue           the batch's draws and the sampler's enqueue
  serve.wait            the completion thread: the batch's event
  serve.copy_out        the batch's rolls to the host
  serve.deliver         the rolls handed to their requests
  unet.block            nn/unet.py, a U-Net block's forward (a SpecUnet
                        block's two streams together, or its part of one)
  unet.linear_attn      a linear attention with its norm and residual
  unet.attn             the bottleneck's full attention, likewise
  unet.resample         a level's down- or up-samplers
  unet.spec_stream      SpecUnetNet.cond_projections: the spectrogram stream
                        alone, once a batch in sampling
  unet.norm             a U-Net GroupNorm (nn/unet.py::GroupNorm), inside
                        `unet.block`, `unet.linear_attn`, `unet.attn` or
                        `unet.spec_stream`
  unet.dwconv           a U-Net depthwise 7x7 conv
                        (nn/unet.py::DepthwiseConv2d), inside `unet.block`
                        or `unet.spec_stream`

A profile records only the threads it was started on unless it is started
with `profile_all_threads` (`torch._C._profiler._ExperimentalConfig`), so
the `serve.*` spans of the dispatcher and completion threads appear only
in such a profile.
"""

from __future__ import annotations

import contextlib
import pathlib
import time
from typing import Optional

from torch.autograd import profiler as _autograd_profiler

_NO_SPAN = contextlib.nullcontext()


def span(name: str, args: Optional[str] = None):
    """`torch.profiler.record_function(name, args)` while a profile records,
    else one shared no-op context: off, a span costs one check."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    from torch.profiler import record_function

    return record_function(name, args)


@contextlib.contextmanager
def trace_if(enabled: bool, log_dir: str):
    """Profile the enclosed block with torch.profiler when enabled."""
    if not enabled:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    pathlib.Path(log_dir).mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(pathlib.Path(log_dir) / "trace.json"))


class StepTimer:
    """Rolling steps/sec + examples/sec between `tick()` calls."""

    def __init__(self):
        self._t: Optional[float] = None
        self._steps = 0
        self._examples = 0

    def tick(self, batch_size: int):
        if self._t is None:
            self._t = time.perf_counter()
        self._steps += 1
        self._examples += batch_size

    def rates(self) -> dict:
        if self._t is None or self._steps == 0:
            return {}
        dt = time.perf_counter() - self._t
        if dt <= 0:
            return {}
        out = {
            "perf/steps_per_sec": self._steps / dt,
            "perf/examples_per_sec": self._examples / dt,
        }
        self._t = time.perf_counter()
        self._steps = 0
        self._examples = 0
        return out
