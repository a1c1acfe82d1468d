"""Offline transcription: recordings one after another through the port's
`transcribe_long` (windows batched on the card, K2 once a batch, the rolls
stitched), each followed by the port's note decoding. Nothing is written.

Set-up builds the model from the seed's weights, makes the mix's recordings
and warms up every batch size the mix produces. The window transcribes the
recordings in the seed's order until its deadline, then finishes the
recording in flight. Each recording draws x_T and the per-step noise from a
`torch.Generator` on the card that the benchmark seeds.

The check takes a seeded sample of the finished recordings' K2 batches,
always one full batch and one short last batch where the window finished
any, and holds each against the reference, run from the same audio, weights
and draws (the draws of the batches before it replayed):
  roll_rms      the widest relative RMS gap of the stitched roll over blocks
                of one window's stride, sqrt(mean (port - ref)^2 / mean ref^2),
                over the frames that the batch's windows alone decide
  notes_differ  notes that the port's decoder and the reference's decoder,
                reading the port's roll, do not both find, over every
                finished recording
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import inputs, port, trace, weights
from ..reference import diffroll as ref

WEIGHT_STREAM, DRAW_STREAM, CHECK_STREAM = 10, 12, 13
MAX_CYCLES = 64   # the seeded order's length, in passes over the mix's recordings


def window_count(samples: int, seq_len: int, stride: int) -> int:
    return max(1, -(-max(samples - seq_len, 0) // stride) + 1)


def batch_sizes(n_windows: int, batch: int) -> List[int]:
    return [min(batch, n_windows - s) for s in range(0, n_windows, batch)]


class Runner:
    def __init__(self, run):
        self.run = run
        cfg, mix = run.cfg, run.mix
        self.sr = cfg["mel"]["sample_rate"]
        hop = cfg["mel"]["hop_length"]
        self.seq_len = cfg["frames"] * hop
        self.stride = self.seq_len - mix["overlap_frames"] * hop
        self.task = None
        self.params: Optional[Dict[str, torch.Tensor]] = None
        self.audio: List[np.ndarray] = []

    # ------------------------------------------------------------ the program
    def transcribe(self, audio: np.ndarray, generator: torch.Generator) -> np.ndarray:
        """The timed path: one recording through the port."""
        from diffroll_tpu_torch.tasks.transcribe import transcribe_long

        mix = self.run.mix
        return transcribe_long(self.task, audio, generator, sample_rate=self.sr,
                               batch_size=mix["batch_size"],
                               overlap_frames=mix["overlap_frames"])

    def decode(self, roll: np.ndarray) -> np.ndarray:
        """The port's note decoder: (N, 3) rows of (key, first frame, end frame)."""
        from diffroll_tpu_torch.eval.notes import extract_notes

        thr = self.run.cfg["frame_threshold"]
        keys, spans = extract_notes(roll, roll, thr, thr)
        return np.concatenate([np.asarray(keys, np.int64).reshape(-1, 1),
                               np.asarray(spans, np.int64).reshape(-1, 2)], 1)

    @staticmethod
    def launches() -> int:
        from diffroll_tpu_torch.ops.sampler_kernel import fused_sample

        return fused_sample.launches

    def generator(self, i: int) -> torch.Generator:
        """The draws of the window's i-th recording."""
        return torch.Generator(device=self.run.device).manual_seed(
            inputs.torch_seed(self.run.seed, DRAW_STREAM, i))

    def windows_of(self, audio: np.ndarray) -> int:
        return window_count(len(audio), self.seq_len, self.stride)

    # ------------------------------------------------------------ phases
    def setup(self) -> None:
        run = self.run
        cfg, mix, dev = run.cfg, run.mix, run.device
        self.params = weights.make(port.model_shapes(cfg),
                                   inputs.torch_seed(run.seed, WEIGHT_STREAM), dev)
        self.task = port.build_task(cfg, port.build_model(cfg, dev, self.params).eval())
        run.mark("model")
        self.audio = inputs.recordings(mix, run.seed, self.sr, dev)
        run.mark("inputs")
        # every batch size the recordings give K2, through the timed path
        sizes = sorted({b for a in self.audio
                        for b in batch_sizes(self.windows_of(a), mix["batch_size"])})
        longest = max(self.audio, key=len)
        for b in sizes:
            cut = longest[: self.seq_len + (b - 1) * self.stride]
            self.decode(self.transcribe(cut, torch.Generator(device=dev).manual_seed(b)))

    def window(self, seconds: float, traced: bool) -> dict:
        """Recordings until the deadline, then the one in flight. With `traced`,
        the recordings from the second on are profiled until `trace_seconds`
        have passed, the last of them finished."""
        run, mix = self.run, self.run.mix
        order = inputs.recording_order(mix, run.seed, cycles=MAX_CYCLES)
        done, k2_before = [], self.launches()
        prof, stretch, traced_from, traced_to = {}, None, None, None
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while True:
            i = len(done)
            if traced and i == 1:
                stretch, traced_from = trace.stretch(prof), time.perf_counter()
                stretch.__enter__()
            audio = self.audio[order[i % len(order)]]
            with trace.annotate("bench.transcribe_long"):
                roll = self.transcribe(audio, self.generator(i))
            with trace.annotate("bench.decode"):
                found = self.decode(roll)
            done.append({"i": i, "recording": order[i % len(order)],
                         "windows": self.windows_of(audio), "roll": roll, "notes": found})
            now = time.perf_counter()
            last = now >= deadline
            if stretch is not None and traced_to is None and (
                    last or now - traced_from >= mix["trace_seconds"]):
                stretch.__exit__(None, None, None)
                traced_to = len(done)
            if last:
                break
        out = {"elapsed_s": time.perf_counter() - t0, "recordings": done,
               "windows": sum(r["windows"] for r in done),
               "k2_launches": self.launches() - k2_before,
               "attempted": len(done), "failed": 0}
        if traced_to is not None:
            out["trace"] = prof["trace"]
            out["traced_windows"] = [r["windows"] for r in done[1:traced_to]]
        return out

    def free(self) -> None:
        """Drop the program's state before the reference runs."""
        self.task = None

    # ------------------------------------------------------------ the check
    def sample(self, records: dict) -> List[Tuple[dict, int]]:
        """A seeded sample of the finished recordings' batches, as (record,
        batch index): first a full batch and a short one, each drawn among
        those the window finished, then others in a seeded order while the
        windows taken stay within `check_windows`."""
        size = self.run.mix["batch_size"]
        units = [(r, k, b) for r in records["recordings"]
                 for k, b in enumerate(batch_sizes(r["windows"], size))]
        g = inputs.rng(self.run.seed, CHECK_STREAM)
        pick, taken, total = [], set(), 0
        for group in ([u for u in units if u[2] == size], [u for u in units if u[2] < size],
                      units):
            for j in g.permutation(len(group)):
                r, k, b = group[int(j)]
                if (r["i"], k) not in taken and total + b <= self.run.mix["check_windows"]:
                    pick.append((r, k))
                    taken.add((r["i"], k))
                    total += b
                    if group is not units:
                        break
        return pick

    def reference_batch(self, audio: np.ndarray, generator: torch.Generator, k: int,
                        precision: str = "f32") -> np.ndarray:
        """The reference's rolls of the recording's k-th batch of windows,
        (b, frames, 88), from the draws of `generator` in the order the port
        takes them: each batch's x_T, then its per-step noise; those of the
        batches before the k-th are drawn and dropped."""
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
            net = ref.Denoiser(self.params, cfg, precision)
            return ref.sample(net, cfg, x_T, noise, ref.conditioner(chunk, cfg)).cpu().numpy()

    def batch_span(self, windows: int, k: int, total: int) -> Tuple[int, int, int]:
        """The frames of the stitched roll that the k-th batch's windows alone
        decide: (first frame of the batch's first window, start, end), start
        and end counted from that first frame; an overlap shared with another
        batch's window is left out."""
        size, frames = self.run.mix["batch_size"], self.run.cfg["frames"]
        overlap = self.run.mix["overlap_frames"]
        step = frames - overlap
        b = batch_sizes(windows, size)[k]
        first = k * size * step
        lo = overlap if k > 0 else 0
        hi = (b - 1) * step + frames - (overlap if (k + 1) * size < windows else 0)
        return first, lo, min(hi, total - first)

    def batch_gap(self, r: dict, k: int, precision: str = "f32",
                  want: Optional[np.ndarray] = None) -> Tuple[float, np.ndarray]:
        """roll_rms of the k-th batch of finished recording `r`, and the
        reference's stitched frames it was read against; with `precision`
        other than f32, the reference in that precision read in the
        program's place against `want`."""
        audio = self.audio[r["recording"]]
        rolls = self.reference_batch(audio, self.generator(r["i"]), k, precision)
        total = len(r["roll"])
        first, lo, hi = self.batch_span(r["windows"], k, total)
        local = ref.stitch(rolls, self.run.mix["overlap_frames"],
                           (len(rolls) - 1) * (self.run.cfg["frames"]
                                               - self.run.mix["overlap_frames"])
                           + self.run.cfg["frames"])[lo:hi]
        if want is None:
            return self.roll_gap(r["roll"][first + lo: first + hi], local), local
        return self.roll_gap(local, want), want

    def roll_gap(self, got: np.ndarray, want: np.ndarray) -> float:
        """The widest relative RMS gap over blocks of one stride."""
        if got.shape != want.shape:
            return float("inf")
        block = self.stride // self.run.cfg["mel"]["hop_length"]
        worst = 0.0
        for s in range(0, len(want), block):
            d, w = got[s: s + block] - want[s: s + block], want[s: s + block]
            gap = float(np.sqrt(np.mean(d * d) / max(np.mean(w * w), 1e-30)))
            worst = max(worst, gap if np.isfinite(gap) else float("inf"))
        return worst

    def check(self, records: dict, control: bool = False) -> Dict[str, float]:
        """The numbers compared, by name; with `control`, also each control's
        reading of roll_rms (`control.roll_rms` for fp8, `control_bf16.roll_rms`
        for bf16 heads, skip sums and sampler state)."""
        ref.exact_f32()
        thr = self.run.cfg["frame_threshold"]
        out = {"roll_rms": 0.0, "notes_differ": 0}
        for r in records["recordings"]:
            theirs = {tuple(n) for n in ref.notes(r["roll"], thr)}
            out["notes_differ"] += len(theirs ^ {tuple(n) for n in r["notes"]})
        controls = {"control": "fp8", "control_bf16": "bf16"} if control else {}
        for name in controls:
            out[f"{name}.roll_rms"] = 0.0
        sizes = []
        for r, k in self.sample(records):
            gap, want = self.batch_gap(r, k)
            out["roll_rms"] = max(out["roll_rms"], gap)
            sizes.append(batch_sizes(r["windows"], self.run.mix["batch_size"])[k])
            for name, precision in controls.items():
                out[f"{name}.roll_rms"] = max(out[f"{name}.roll_rms"],
                                              self.batch_gap(r, k, precision, want)[0])
        out["checked_windows"] = sum(sizes)
        out["checked_batch_sizes"] = sizes
        return out
