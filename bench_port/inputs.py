"""The benchmark's one traffic generator. A mix is a data file,
`bench_port/traffic/<mix>.json`; this module reads it and, from `--seed`,
makes what the mix's runner (`runners/<runner>.py`) feeds the program.

Every seed gets the same set of sizes in another order, so the work a run
does depends on the seed only through its order.

Keys of a mix:
  runner            the runner module that runs it
  recordings        {"seconds_min", "seconds_max", "count"}: `count` recording
                    lengths at the mid-quantiles of a log-uniform law between
                    the two, each a new seeded chord recording; the window
                    transcribes them in a seeded order, cycle after cycle
  batch_size, overlap_frames    `transcribe_long`'s arguments
  check_windows     the most windows of finished recordings the check holds
                    against the reference
  trace_seconds     the traced stretch of a `--trace 1` run, at least
  batch, pool       training: windows a step, distinct batches made
  note_density      training: the share of (frame block, key) cells a note holds
  note_frames       training: the frames a note lasts
"""

from __future__ import annotations

import math
from typing import List

import numpy as np


def rng(seed: int, *stream: int) -> np.random.Generator:
    """A numpy generator for one purpose of one seed."""
    return np.random.default_rng([int(seed) & 0xFFFFFFFFFFFFFFFF, *stream])


def torch_seed(seed: int, *stream: int) -> int:
    """A 63-bit seed for a `torch.Generator`, for one purpose of one seed."""
    return int(rng(seed, *stream).integers(0, 2 ** 63 - 1))


def recording_seconds(mix: dict) -> List[float]:
    """The mix's recording lengths: the mid-quantiles (i + 1/2) / count of a
    log-uniform law on [seconds_min, seconds_max]."""
    r = mix["recordings"]
    lo, hi, n = math.log(r["seconds_min"]), math.log(r["seconds_max"]), r["count"]
    return [math.exp(lo + (hi - lo) * (i + 0.5) / n) for i in range(n)]


def recording_order(mix: dict, seed: int, cycles: int) -> List[int]:
    """Indices into `recording_seconds`, every recording once a cycle. The
    recordings are paired shortest with longest, second shortest with second
    longest, and so on; a cycle takes the pairs in a seeded order, each pair's
    two in a seeded order, so that any run of pairs holds short and long
    recordings alike."""
    g = rng(seed, 1)
    n = mix["recordings"]["count"]
    pairs = [(i, n - 1 - i) if i != n - 1 - i else (i,) for i in range(n // 2 + n % 2)]
    out: List[int] = []
    for _ in range(cycles):
        for p in g.permutation(len(pairs)):
            pair = pairs[int(p)]
            out += [pair[int(k)] for k in g.permutation(len(pair))]
    return out


def chord_audio(seconds: float, sr: int, seed: int, device="cpu") -> np.ndarray:
    """A few seeded sine chords, one a second: in each whole second k, for
    [k, k + 0.9) s, three keys drawn from MIDI 40-79 at amplitude 0.1 (the
    port's `profile_serve.chord_audio`, computed on `device` in float64)."""
    import torch

    g = np.random.default_rng(seed)
    n, whole = int(seconds * sr), int(seconds)
    keys = [g.integers(40, 80, size=3) for _ in range(whole)]
    rate = torch.tensor([[2 * np.pi * 440.0 * 2 ** ((m - 69) / 12) for m in k] for k in keys]
                        or [[0.0] * 3], dtype=torch.float64, device=device)
    i = torch.arange(n, dtype=torch.float64, device=device)
    t = i / sr
    sec = torch.div(i, sr, rounding_mode="floor")
    on = (sec < whole) & (t < sec + 0.9)
    rate = rate[sec.clamp(max=max(whole - 1, 0)).long()]
    out = torch.zeros(n, dtype=torch.float64, device=device)
    for c in range(3):
        out += torch.where(on, 0.1 * torch.sin(rate[:, c] * t), 0.0)
    return out.float().cpu().numpy()


def recordings(mix: dict, seed: int, sr: int, device="cpu") -> List[np.ndarray]:
    """The mix's recordings for this seed, one seeded chord track each."""
    g = rng(seed, 2)
    return [chord_audio(sec, sr, int(g.integers(0, 2 ** 31)), device)
            for sec in recording_seconds(mix)]
