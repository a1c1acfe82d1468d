"""Render an on-disk MAPS-layout synthetic corpus of v2 audio (counterpart
of `tools/make_synthetic_tree.py`).

Writes wav + MIDI pairs under <out>/MAPS/AkPnBcht/MUS (train) and
<out>/MAPS/ENSTDkAm/MUS (test), so the CLI pipeline (`train`, `test`,
`sweep`, data/amt.MAPS) runs end to end without a dataset download. The
audio is the v2 renderer of `synthetic_end_to_end` (velocity, onset jitter,
inharmonic partials, hammer noise, reverb, a pink floor); the files are byte
for byte the JAX tool's.

    python -m diffroll_tpu_torch.quality.make_synthetic_tree out=outputs/synth_tree \
        n_train=96 n_test=8 seconds=20.48 [seed=0]
"""

from __future__ import annotations

import pathlib
from typing import List, Optional, Tuple

import numpy as np

from ..io import write_midi, write_wav
from ..io.midi import MidiNote
from .synthetic_end_to_end import SR, parse_args, render_notes_v2


def make_notes(seed, seconds):
    """Random chords across `seconds`: 1-4 notes of MIDI 30-85 at a time,
    velocities 40-126."""
    rng = np.random.RandomState(seed)
    notes, tpos = [], 0.1
    while tpos < seconds - 0.5:
        dur = rng.uniform(0.15, 0.9)
        for p in rng.choice(np.arange(30, 86), size=rng.randint(1, 5),
                            replace=False):
            notes.append(MidiNote(tpos, tpos + dur, int(p),
                                  int(rng.randint(40, 127))))
        tpos += rng.uniform(0.15, 0.6)
    return notes


def render_recording(seed: int, seconds: float) -> Tuple[list, np.ndarray]:
    """(notes, v2 audio of int(seconds * SR) samples) of recording `seed`."""
    notes = make_notes(seed, seconds)
    rng = np.random.RandomState(1_000_000 + seed)
    return notes, render_notes_v2(notes, int(seconds * SR), rng)


def write_tree(out: pathlib.Path, n_train: int = 96, n_test: int = 8, seconds: float = 20.48,
               seed: int = 0) -> None:
    """`n_train` recordings of `seconds` for training, `n_test` for testing."""
    specs = [("AkPnBcht", n_train, 0), ("ENSTDkAm", n_test, 100_000)]
    for subset, n, base in specs:
        d = out / "MAPS" / subset / "MUS"
        d.mkdir(parents=True, exist_ok=True)
        for i in range(n):
            notes, audio = render_recording(seed + base + i, seconds)
            write_wav(d / f"clip{i}.wav", audio, SR)
            write_midi(str(d / f"clip{i}.mid"),
                       [n_.pitch for n_ in notes],
                       [(n_.onset, n_.offset) for n_ in notes],
                       velocities=[n_.velocity for n_ in notes])
        print(f"{subset}: {n} clips x {seconds:.2f}s -> {d}")


def main(argv: Optional[List[str]] = None) -> pathlib.Path:
    args = parse_args(argv)
    out = pathlib.Path(args.get("out", "outputs/synth_tree"))
    write_tree(out, n_train=int(args.get("n_train", 96)), n_test=int(args.get("n_test", 8)),
               seconds=float(args.get("seconds", 20.48)), seed=int(args.get("seed", 0)))
    return out


if __name__ == "__main__":
    main()
