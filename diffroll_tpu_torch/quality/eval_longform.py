"""Long-audio transcription quality (counterpart of `tools/eval_longform.py`).

`tasks/transcribe.py::transcribe_long` (windows, batched sampling,
crossfade stitching) goes past the reference's 20.48 s limit (reference
README.md:126). This tool renders one multi-minute v2 piece with a known
note list, transcribes it through the `transcribe` entry
(`cli/transcribe.py::main`) at the stitched (overlap_frames=32) and the
butted (overlap_frames=0) protocol, and scores note and frame F1 of the
whole roll against the rasterized ground truth.

    python -m diffroll_tpu_torch.quality.eval_longform ckpt=<file.ckpt> seconds=180 \
        w=0.5 [overlaps=32,0] [seed=3000000] [out=longform.json] [device=cuda|cpu] \
        [model.frames=...]

Keys with a dot (`model.frames=16`, `dataloader.test_batch_size=8`) go to
`transcribe` as they are. The piece and its label are the JAX tool's bits.
"""

from __future__ import annotations

import json
import pathlib
import sys
import tempfile
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..cli import transcribe as transcribe_cli
from ..data.rasterize import rasterize_arrays
from ..eval.evaluate import evaluate_rolls
from ..io import write_midi, write_wav
from .make_synthetic_tree import render_recording
from .synthetic_end_to_end import HOP, SR, parse_args


def longform_piece(seed: int, seconds: float) -> Tuple[list, np.ndarray, np.ndarray]:
    """(notes, audio (seconds * SR,), label (n_frames, 88)) of one piece."""
    notes, audio = render_recording(seed, seconds)
    n_frames = len(audio) // HOP
    label, _ = rasterize_arrays(
        np.array([n.onset for n in notes]),
        np.array([n.offset for n in notes]),
        np.array([n.pitch for n in notes]),
        n_frames, HOP, SR, 21, 108,
    )
    return notes, audio, label


def main(argv: Optional[List[str]] = None) -> Dict:
    args = parse_args(argv)
    ckpt = args["ckpt"]
    seconds = float(args.get("seconds", "180"))
    seed = int(args.get("seed", "3000000"))  # disjoint from the corpus seeds
    w = float(args.get("w", "0.5"))
    passthrough = [f"{k}={v}" for k, v in args.items() if "." in k]

    notes, audio, label = longform_piece(seed, seconds)
    n_frames = label.shape[0]

    results = {}
    with tempfile.TemporaryDirectory(prefix="longform_") as td:
        folder = pathlib.Path(td) / "audio"
        folder.mkdir()
        write_wav(folder / "piece.wav", audio, SR)
        write_midi(str(folder / "piece_label.mid"),
                   [n.pitch for n in notes],
                   [(n.onset, n.offset) for n in notes])
        for overlap in (int(x) for x in args.get("overlaps", "32,0").split(",")):
            t0 = time.perf_counter()
            run_dir = transcribe_cli.main([
                f"pretrained_path={ckpt}",
                f"dataset.audio_path={folder}", "dataset.audio_ext=wav",
                f"task.w={w}", f"overlap_frames={overlap}",
                "dataloader.num_workers=1", f"device={args.get('device', 'cuda')}",
                f"trainer.output_dir={td}/out_ov{overlap}", *passthrough,
            ])
            wall = time.perf_counter() - t0
            pred = np.load(sorted(run_dir.glob("*piece.npz"))[0])["roll"]
            if pred.shape[0] < n_frames:
                raise RuntimeError(f"transcribe gave {pred.shape[0]} frames for {n_frames}")
            metrics = evaluate_rolls(pred[None, :n_frames], label[None], frame_threshold=0.5,
                                     hop_length=HOP, sample_rate=SR)
            results[f"overlap_{overlap}"] = {**metrics, "wall_s": round(wall, 1)}
            print(f"[overlap={overlap}] note_f1={metrics['note_f1']:.4f} "
                  f"frame_f1={metrics['frame_f1']:.4f} ({wall:.0f}s)", file=sys.stderr,
                  flush=True)

    payload = {"ckpt": ckpt, "seconds": seconds, "seed": seed, "w": w,
               "n_notes": len(notes), "n_frames": int(n_frames), "results": results}
    out = args.get("out")
    if out:
        pathlib.Path(out).write_text(json.dumps(payload, indent=2) + "\n")
    print(json.dumps(payload))
    return payload


if __name__ == "__main__":
    main()
