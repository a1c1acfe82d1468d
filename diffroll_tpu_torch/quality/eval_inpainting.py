"""Inpainting quality: F1 inside and outside a masked band, against
transcription and generation (counterpart of `tools/eval_inpainting.py`).

The reference's second capability (reference sampling.py:29-43;
task/diffusion.py:999-1025) is inpainting: the spectrogram conditioner is
forced to -1 inside a band, and the model must reconstruct the roll there
from musical context and the learned roll prior, while transcribing
normally outside. This tool measures that over a checkpoint's test split:

  * three conditions over the same held-out windows and noise draws:
      transcription  cfdg_ddpm_x0        (no mask; the ceiling inside the band)
      inpainting     inpainting_ddpm_x0  (the band's conditioner := -1)
      generation     generation_ddpm_x0  (the whole conditioner := -1; the
                                          floor, what the roll prior alone gives)
  * frame and note F1 scored separately INSIDE the band and OUTSIDE it
    (`band_scores`: the rolls sliced to the region; a note that crosses the
    band's edge is cut the same way in the prediction and the label).

A time band (`mask=t0,t1`, frames) splits along time. A frequency band
(`fmask=m0,m1`, HTK mel bins: the reference's `inpainting_f`) splits along
the pitch axis: a key is inside when its fundamental falls in the Hz span
the masked bins cover (`fmask_keys`: the filterbank's edges
mel_to_hz(points[m0]) .. points[m1 + 1]). Harmonics of the inside keys stay
visible in the unmasked bins above the band, so inside-band recovery
measures fundamental-suppressed transcription, not pure generation.

    python -m diffroll_tpu_torch.quality.eval_inpainting ckpt=<file.ckpt> \
        root=<MAPS tree> mask=48,80 w=0.5 [out=inpainting.json] [device=cuda|cpu]
    python -m diffroll_tpu_torch.quality.eval_inpainting ckpt=<file.ckpt> \
        root=<MAPS tree> fmask=29,51 w=0.5

Keys with a dot (`model.frames=16`) go to the config and over the
checkpoint's model config as they are.

Windows are butted (eval_overlap_frames=0), so the band sits at the same
frames of every window. The payload names the checkpoint file and the
`global_step` it records, the training step whose weights were scored. Each condition samples through `DiffusionTask.sample`
(K2 on the card, K1 inside it); x_T and the per-step noise come from a
generator seeded 7, the same draws for every condition.
"""

from __future__ import annotations

import json
import pathlib
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..cli import _common
from ..compat import peek_global_step
from ..config import compose
from ..dsp.mel import MelConfig, hz_to_mel_htk, mel_to_hz_htk
from ..eval.evaluate import evaluate_rolls
from ..tasks import DiffusionTask
from .synthetic_end_to_end import parse_args


def fmask_keys(m0: int, m1: int, mel: MelConfig) -> Tuple[float, float, int, int]:
    """The masked mel bins [m0, m1) as (hz_lo, hz_hi, k0, k1): the Hz span
    their filters cover, and the keys [k0, k1) of the 88 whose fundamental
    falls inside it."""
    pts = mel_to_hz_htk(np.linspace(hz_to_mel_htk(mel.f_min), hz_to_mel_htk(mel.f_max),
                                    mel.n_mels + 2))
    hz_lo, hz_hi = float(pts[m0]), float(pts[m1 + 1])
    midi = 21 + np.arange(88)
    f0s = 440.0 * 2.0 ** ((midi - 69) / 12.0)
    inside = np.where((f0s >= hz_lo) & (f0s < hz_hi))[0]
    return hz_lo, hz_hi, int(inside[0]), int(inside[-1]) + 1


def band_scores(pred: np.ndarray, label: np.ndarray, *, frames: Optional[Tuple[int, int]] = None,
                keys: Optional[Tuple[int, int]] = None, frame_threshold: float = 0.5,
                hop_length: int = 512, sample_rate: int = 16000) -> Tuple[Dict, Dict]:
    """(inside, outside) metrics of (B, T, 88) rolls for a band of `frames`
    [t0, t1) or of `keys` [k0, k1). Note decoding is per key, so slicing
    columns keeps note events; the key -> Hz shift is the same for the
    prediction and the label, which leaves the pitch matching unaffected."""
    def score(p, lbl):
        return evaluate_rolls(p, lbl, frame_threshold=frame_threshold, hop_length=hop_length,
                              sample_rate=sample_rate)

    if (frames is None) == (keys is None):
        raise ValueError("give one band: frames=(t0, t1) or keys=(k0, k1)")
    axis, (a, b) = (1, frames) if frames is not None else (2, keys)

    def cut(x, lo, hi):
        return x[:, lo:hi] if axis == 1 else x[:, :, lo:hi]

    inside = score(cut(pred, a, b), cut(label, a, b))
    outside = score(
        np.concatenate([cut(pred, None, a), cut(pred, b, None)], axis=axis),
        np.concatenate([cut(label, None, a), cut(label, b, None)], axis=axis))
    return inside, outside


def main(argv: Optional[List[str]] = None) -> Dict:
    args = parse_args(argv)
    ckpt = args["ckpt"]
    fmask = args.get("fmask")
    if fmask is not None:
        m0, m1 = (int(x) for x in fmask.split(","))
    else:
        t0, t1 = (int(x) for x in args.get("mask", "48,80").split(","))
    w = float(args.get("w", "0.5"))
    seq = int(args.get("seq", "65536"))
    # dotted keys (`model.frames=16`) go to the config as they are
    extra = {k: v for k, v in args.items() if "." in k}

    cfg = compose("test", {
        "pretrained_path": ckpt,
        "dataset.root": args["root"],
        "dataset.sequence_length": seq,
        "dataset.eval_overlap_frames": 0,
        "dataloader.test_batch_size": int(args.get("batch", "8")),
        "dataloader.num_workers": 2,
        "trainer.output_dir": args.get("tmpdir", "outputs/eval_inpainting"),
        "device": args.get("device", "cuda"),
        **extra,
    })
    cfg, model, _, _ = _common.load_pretrained(cfg, overrides=extra)
    win = seq // cfg.dataset.hop_length
    if fmask is None:
        if not 0 <= t0 < t1 <= win:
            raise SystemExit(f"mask={t0},{t1} is not inside the {win}-frame window")
        inpaint_kw = dict(inpainting_t=(t0, t1), inpainting_f=None)
        band = dict(frames=(t0, t1))
    else:
        mel = model.config.mel
        if not 0 <= m0 < m1 <= mel.n_mels:
            raise SystemExit(f"fmask={m0},{m1} is not inside the {mel.n_mels} mel bins")
        inpaint_kw = dict(inpainting_t=None, inpainting_f=(m0, m1))
        hz_lo, hz_hi, k0, k1 = fmask_keys(m0, m1, mel)
        band = dict(keys=(k0, k1))
        print(f"[fmask] mel bins [{m0},{m1}) => {hz_lo:.0f}-{hz_hi:.0f} Hz "
              f"=> keys [{k0},{k1}) (midi {21 + k0}-{21 + k1 - 1})", file=sys.stderr, flush=True)

    conditions = {
        "transcription": cfg.task.replace(sampling_type="cfdg_ddpm_x0", w=w,
                                          inpainting_t=None, inpainting_f=None),
        "inpainting": cfg.task.replace(sampling_type="inpainting_ddpm_x0", w=w, **inpaint_kw),
        "generation": cfg.task.replace(sampling_type="generation_ddpm_x0", w=w,
                                       inpainting_t=None, inpainting_f=None),
    }

    ds = _common.build_dataset(cfg.dataset, "test")
    device = model.device
    results = {}
    for name, task_cfg in conditions.items():
        task = DiffusionTask(model, task_cfg)
        gen = torch.Generator(device=device).manual_seed(7)
        preds, labels = [], []
        for batch in _common.build_loader(cfg, ds, "test"):
            frame = np.asarray(batch["frame"])
            audio = torch.from_numpy(np.asarray(batch["audio"], np.float32)).to(device)
            x_T = torch.randn(frame.shape, generator=gen, device=device)
            preds.append(task.sample(x_T, waveform=audio, generator=gen)[0].cpu().numpy())
            labels.append(frame)
        pred = np.concatenate(preds)
        label = np.concatenate(labels)
        inside, outside = band_scores(
            pred, label, frame_threshold=cfg.task.frame_threshold,
            hop_length=cfg.dataset.hop_length, sample_rate=cfg.dataset.sampling_rate, **band)
        results[name] = {"inside_mask": inside, "outside_mask": outside,
                         "n_windows": int(pred.shape[0])}
        print(f"[{name}] inside note_f1={inside['note_f1']:.3f} "
              f"frame_f1={inside['frame_f1']:.3f} | outside note_f1={outside['note_f1']:.3f} "
              f"frame_f1={outside['frame_f1']:.3f}", file=sys.stderr, flush=True)

    payload = {"ckpt": ckpt, "global_step": peek_global_step(ckpt), "w": w,
               "window_frames": win, "eval_overlap_frames": 0, "results": results}
    if fmask is None:
        payload["mask_frames"] = [t0, t1]
    else:
        payload["mask_mel_bins"] = [m0, m1]
        payload["mask_hz"] = [round(hz_lo, 1), round(hz_hi, 1)]
        payload["mask_keys"] = [k0, k1]
    out = args.get("out")
    if out:
        pathlib.Path(out).write_text(json.dumps(payload, indent=2))
    print(json.dumps(payload))
    return payload


if __name__ == "__main__":
    main()
