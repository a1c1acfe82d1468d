"""End-to-end learning check on synthetic audio (counterpart of
`examples/synthetic_end_to_end.py`): train the spec-conditioned flagship,
scaled down to 128 channels x 8 layers, on rendered "piano" clips, then
transcribe held-out clips and score note and frame F1.

The corpus is built from numpy alone: each MIDI note renders as a decaying
harmonic tone at its fundamental (v1), or as piano-shaped audio (v2:
velocity, onset jitter, inharmonic partials, hammer noise, reverb, a pink
floor). So the audio -> roll mapping is learnable, and a working mel front
end, conditioning, diffusion training, guided sampler and note decoding
must reach a high F1 together.

    python -m diffroll_tpu_torch.quality.synthetic_end_to_end [steps=2000] \
        [n_train=64] [corpus=v2|v1] [dtype=float32] [fused_train=1|0] \
        [pretrain_steps=0 n_pretrain=256] [sweep_steps=1] \
        [distill=1 distill_start=13 distill_stages=3 distill_steps=1500 distill_lr=1e-4] \
        [device=cuda|cpu]

`fused_train=1` trains the residual stack through the training kernels (K3 +
K4) on a CUDA model (their plain versions on the CPU); 0 through the
`nn.Module`s under autograd. It defaults to 1 on the card, 0 on the CPU.
Scoring runs `DiffusionTask.sample` (K2 on the card). The batch indices and
the training noise come from a `torch.Generator` on the model's device,
seeded as the JAX script seeds its keys (training 1, pretraining 21, the
scored x_T and noise 7, the distillation batches 11), never with JAX's bits.
The printed JSON has the JAX script's keys, plus `fused_train`, `device` and
`losses` (the training loss every 200 steps and at the last).

`channels=`, `layers=`, `frames=`, `timesteps=` and `n_test=` shrink the
check for a CPU run (the renderers keep their bits at the default 128
frames).
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import models
from ..cli._common import device_named
from ..config import DistillConfig
from ..data.rasterize import rasterize_notes
from ..eval.evaluate import evaluate_rolls
from ..io.midi import MidiNote
from ..models.base import DiffRollModel
from ..tasks import DiffusionTask, TaskConfig
from ..train import TrainState, make_train_step

SR, HOP, FRAMES = 16000, 512, 128
SEQ = FRAMES * HOP
TIMESTEPS = 100
BATCH = 8
N_TEST = 8


def render_notes(notes, n_samples, rng):
    """Corpus v1: decaying 3-harmonic tones at each note's fundamental."""
    t = np.arange(n_samples) / SR
    audio = np.zeros(n_samples, np.float32)
    for n in notes:
        f0 = 440.0 * 2 ** ((n.pitch - 69) / 12)
        i0, i1 = int(n.onset * SR), min(int(n.offset * SR), n_samples)
        if i1 <= i0:
            continue
        seg = t[: i1 - i0]
        env = np.exp(-3.0 * seg)
        tone = sum((0.6 ** k) * np.sin(2 * np.pi * f0 * (k + 1) * seg + rng.uniform(0, 6.28))
                   for k in range(3))
        audio[i0:i1] += (0.2 * env * tone).astype(np.float32)
    return audio + rng.normal(0, 0.003, n_samples).astype(np.float32)


def render_notes_v2(notes, n_samples, rng):
    """Corpus v2, piano-shaped: per-note velocity scaling, +-10 ms audio
    onset jitter against the label grid, 6 inharmonic partials (f_k = k f0
    sqrt(1 + B k^2), a stiff string's B) with a velocity-dependent rolloff,
    a pitch-dependent decay, a hammer-like noise transient at each onset, a
    short synthetic reverb tail and a pink-ish noise floor. The labels stay
    on the exact rasterized grid, so the model has to tolerate the audio's
    misalignment as it would on a real piano."""
    audio = np.zeros(n_samples + SR, np.float32)  # headroom for the jitter and the IR
    for n in notes:
        f0 = 440.0 * 2 ** ((n.pitch - 69) / 12)
        vel = n.velocity / 127.0
        jitter = rng.uniform(-0.010, 0.010)
        i0 = max(0, int((n.onset + jitter) * SR))
        # strings ring past the nominal offset (a short release)
        i1 = min(int((n.offset + jitter + 0.06) * SR), len(audio))
        if i1 <= i0:
            continue
        seg = np.arange(i1 - i0) / SR
        decay = 2.0 + 4.0 * (n.pitch - 21) / 87.0      # high notes die fast
        env = np.exp(-decay * seg) * (1 - np.exp(-seg * 400.0))  # soft attack
        B = 3e-4                                        # string stiffness
        rolloff = 0.45 + 0.25 * vel                     # hard hits are brighter
        tone = np.zeros_like(seg)
        for k in range(6):
            fk = f0 * (k + 1) * np.sqrt(1 + B * (k + 1) ** 2)
            if fk >= SR / 2:
                break
            tone += (rolloff ** k) * np.sin(
                2 * np.pi * fk * seg + rng.uniform(0, 6.28))
        note_audio = 0.25 * vel * env * tone
        # hammer strike: a few ms of decaying broadband noise at the onset
        n_att = min(int(0.006 * SR), i1 - i0)
        note_audio[:n_att] += (0.05 * vel * rng.randn(n_att)
                               * np.exp(-np.arange(n_att) / (0.002 * SR)))
        audio[i0:i1] += note_audio.astype(np.float32)
    # a light room: an exponentially decaying noise IR (~120 ms), 12% wet
    ir_len = int(0.12 * SR)
    ir = (rng.randn(ir_len) * np.exp(-np.arange(ir_len) / (0.03 * SR))
          ).astype(np.float32)
    ir *= 0.12 / (np.sqrt(np.sum(ir ** 2)) + 1e-9)
    n_fft = 1 << int(np.ceil(np.log2(len(audio) + ir_len)))
    wet = np.fft.irfft(np.fft.rfft(audio, n_fft) * np.fft.rfft(ir, n_fft),
                       n_fft)[: len(audio)]
    audio = audio + wet.astype(np.float32)
    # a pink-ish floor: white plus integrated white
    white = rng.randn(n_samples).astype(np.float32)
    pink = np.cumsum(rng.randn(n_samples)).astype(np.float32)
    pink /= (np.abs(pink).max() + 1e-9) / 3.0
    return audio[:n_samples] + 0.002 * white + 0.002 * pink


def make_clip(seed, corpus="v2", frames=FRAMES):
    """One (audio (frames * HOP,), roll (frames, 88)) clip from `seed`."""
    seq = frames * HOP
    rng = np.random.RandomState(seed)
    notes = []
    tpos = 0.1
    lo, hi = (30, 86) if corpus == "v2" else (40, 80)
    max_poly = 5 if corpus == "v2" else 3
    while tpos < seq / SR - 0.5:
        dur = rng.uniform(0.15, 0.7)
        for p in rng.choice(np.arange(lo, hi), size=rng.randint(1, max_poly + 1),
                            replace=False):
            vel = int(rng.randint(40, 127)) if corpus == "v2" else 100
            notes.append(MidiNote(tpos, tpos + dur, int(p), vel))
        tpos += rng.uniform(0.15, 0.6)
    frame, _ = rasterize_notes(notes, frames, HOP, SR)
    render = render_notes_v2 if corpus == "v2" else render_notes
    return render(notes, seq, rng), frame


# ---------------------------------------------------------------- the entry


def parse_args(argv: Optional[List[str]]) -> Dict[str, str]:
    """`key=value` tokens, as the JAX scripts read `sys.argv`."""
    argv = sys.argv[1:] if argv is None else argv
    return dict(a.split("=", 1) for a in argv if "=" in a)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def build_twin(args: Dict[str, str], spec_dropout: float = 0.1,
               dtype: Optional[str] = None) -> DiffRollModel:
    """The 128 x 8 twin of the flagship (`channels=`, `layers=`, `frames=`,
    `timesteps=` override its size), initialised from the global torch seed."""
    return models.build(
        "ClassifierFreeDiffRoll", residual_channels=int(args.get("channels", 128)),
        residual_layers=int(args.get("layers", 8)), frames=int(args.get("frames", FRAMES)),
        timesteps=int(args.get("timesteps", TIMESTEPS)), spec_dropout=spec_dropout,
        dtype=dtype or args.get("dtype", "float32"))


def stack_clips(clips) -> Tuple[np.ndarray, np.ndarray]:
    return np.stack([a for a, _ in clips]), np.stack([f for _, f in clips])


def run_training(model: DiffRollModel, task_config: TaskConfig, frames: torch.Tensor,
                 audio: torch.Tensor, n_steps: int, seed: int, tag: str,
                 batch: int = BATCH) -> Tuple[TrainState, Dict[int, float]]:
    """`n_steps` Adam steps on random batches of the clips (on the model's
    device). Each step draws its indices (without replacement), then the
    loss's t, noise and spec-dropout mask, from one generator seeded `seed`.
    Returns the state and the loss every 200 steps and at the last."""
    task = DiffusionTask(model, task_config)
    state = TrainState.create(model, task_config.lr)
    step = make_train_step(task.loss_fn)
    gen = torch.Generator(device=model.device).manual_seed(seed)
    n_clips = frames.shape[0]
    bsz = min(batch, n_clips)
    losses: Dict[int, float] = {}
    t0 = time.time()
    for i in range(n_steps):
        idx = torch.randperm(n_clips, generator=gen, device=model.device)[:bsz]
        out = step(state, {"frame": frames[idx], "audio": audio[idx]}, gen)
        if i % 200 == 0 or i == n_steps - 1:
            losses[i] = float(out["diffusion_loss"])
            log(f"{tag} step {i}: loss {losses[i]:.4f} ({time.time() - t0:.0f}s)")
    model.eval()
    return state, losses


@dataclasses.dataclass
class Twin:
    """A trained twin and its held-out clips, ready to be scored."""

    model: DiffRollModel
    task_config: TaskConfig
    test_audio: torch.Tensor    # (n_test, frames * HOP) on the model's device
    test_frame: np.ndarray      # (n_test, frames, 88)

    def score(self, sampler: str, n_steps: Optional[int], model: Optional[DiffRollModel] = None,
              w: Optional[float] = None) -> Dict[str, float]:
        """F1 of the held-out clips' rolls by `sampler` at `n_steps` (`model`
        defaults to the twin's, `w` to the task's): x_T, then the per-step
        noise, from a generator seeded 7, alike for every call."""
        model = self.model if model is None else model
        cfg = self.task_config.replace(sampling_type=sampler, sampling_steps=n_steps,
                                       w=self.task_config.w if w is None else w)
        dev = model.device
        gen = torch.Generator(device=dev).manual_seed(7)
        x_T = torch.randn(self.test_frame.shape, generator=gen, device=dev)
        pred = DiffusionTask(model, cfg).sample(x_T, waveform=self.test_audio, generator=gen)[0]
        return evaluate_rolls(pred.float().cpu().numpy(), self.test_frame,
                              frame_threshold=0.5, hop_length=HOP, sample_rate=SR)


Clips = Tuple[torch.Tensor, torch.Tensor, np.ndarray, np.ndarray]


def check_clips(args: Dict[str, str], device: torch.device) -> Clips:
    """The check's clips: the training audio and rolls (clip seeds 0 ..
    n_train - 1) on `device`, the held-out audio and rolls (1000 ..) in numpy."""
    frames_n = int(args.get("frames", FRAMES))
    corpus = args.get("corpus", "v2")  # v2: the harder piano-shaped audio
    train_audio, train_frame = (torch.from_numpy(a).to(device) for a in stack_clips(
        [make_clip(i, corpus, frames_n) for i in range(int(args.get("n_train", 64)))]))
    test_audio, test_frame = stack_clips([make_clip(1000 + i, corpus, frames_n)
                                          for i in range(int(args.get("n_test", N_TEST)))])
    return train_audio, train_frame, test_audio, test_frame


def learning_check(args: Dict[str, str], seed: int = 0, clips: Optional[Clips] = None,
                   start: Optional[Dict[str, torch.Tensor]] = None) -> Tuple[Dict, Twin]:
    """The whole check from `seed`: the weights drawn after
    `torch.manual_seed(seed)`, the training stream seeded `seed + 1` (seed 0
    is the JAX script's keys 0 and 1). `clips` is `check_clips(args,
    device)`'s, rendered once for several seeds; `start`, a state dict of the
    twin's net, replaces the drawn weights. Returns the JSON record and the
    trained twin."""
    device = device_named(args.get("device", "cuda"))
    steps = int(args.get("steps", 2000))
    n_train = int(args.get("n_train", 64))
    frames_n = int(args.get("frames", FRAMES))
    timesteps = int(args.get("timesteps", TIMESTEPS))
    corpus = args.get("corpus", "v2")
    dtype = args.get("dtype", "float32")
    fused = bool(int(args.get("fused_train", 1 if device.type == "cuda" else 0)))

    if clips is None:
        log("building synthetic dataset...")
        clips = check_clips(args, device)
    train_audio, train_frame, test_audio, test_frame = clips

    torch.manual_seed(seed)  # the weight init
    model = build_twin(args)
    if start is not None:
        model.net.load_state_dict(start)
    model = model.to(device)
    task_config = TaskConfig(timesteps=timesteps, training_mode="x_0", loss_type="l2", lr=4e-4,
                             sampling_type="cfdg_ddpm_x0", w=0.5, fused_train=fused)

    pretrain_steps = int(args.get("pretrain_steps", 0))
    if pretrain_steps:
        # stage 1 of the reference's flagship recipe: roll-prior pretraining
        # with spec_dropout=1 on a larger set whose pairing is treated as
        # unavailable (the conditioner is always dropped to -1, so only the
        # rolls matter; reference unsupervised_pretrained.yaml)
        n_pre = int(args.get("n_pretrain", 4 * n_train))
        _, pre_frame = stack_clips([make_clip(5000 + i, corpus, frames_n) for i in range(n_pre)])
        # the audio is irrelevant under p=1; noise keeps the mel path honest
        pre_audio = np.random.RandomState(9).randn(
            n_pre, frames_n * HOP).astype(np.float32) * 0.05
        pre_model = build_twin(args, spec_dropout=1.0).to(device)
        pre_model.net.load_state_dict(model.net.state_dict())
        run_training(pre_model, task_config, torch.from_numpy(pre_frame).to(device),
                     torch.from_numpy(pre_audio).to(device), pretrain_steps, seed=21,
                     tag="pretrain")
        model.net.load_state_dict(pre_model.net.state_dict())
        del pre_model

    t0 = time.time()
    _, losses = run_training(model, task_config, train_frame, train_audio, steps,
                             seed=seed + 1, tag=f"seed {seed} train")
    twin = Twin(model, task_config, torch.from_numpy(test_audio).to(device), test_frame)

    log("transcribing held-out clips...")
    m = twin.score(task_config.sampling_type, task_config.sampling_steps)
    m["train_steps"] = steps
    m["wall_s"] = round(time.time() - t0, 1)
    m["dtype"] = dtype
    m["corpus"] = corpus
    m["fused_train"] = fused
    m["device"] = device.type
    m["seed"] = seed
    m["losses"] = {str(k): v for k, v in losses.items()}
    if pretrain_steps:
        m["pretrain_steps"] = pretrain_steps

    if args.get("sweep_steps"):
        # the quality-vs-steps curve: how few reverse steps keep the dense
        # schedule's F1 (the strided few-step path, diffusion/loop.py)
        m["steps_sweep"] = {}
        for sampler in ("cfdg_ddpm_x0", "cfdg_ddim_x0"):
            for n_steps in (None, 50, 20, 10):
                s = twin.score(sampler, n_steps)
                tag = f"{sampler}@{n_steps or timesteps}"
                m["steps_sweep"][tag] = {"note_f1": round(s["note_f1"], 3),
                                         "frame_f1": round(s["frame_f1"], 3)}
                log(f"{tag}: note {s['note_f1']:.3f} frame {s['frame_f1']:.3f}")

    if args.get("distill"):
        # guided progressive distillation (train/distill.py): single-forward
        # few-step students against the undistilled strided sampler at the
        # same step counts
        from ..train.distill import progressive_distill

        def batches():
            gen = torch.Generator(device=device).manual_seed(11)
            while True:
                idx = torch.randperm(n_train, generator=gen, device=device)[:BATCH]
                yield {"frame": train_frame[idx], "audio": train_audio[idx]}

        dcfg = DistillConfig(
            start_steps=int(args.get("distill_start", 13)),
            stages=int(args.get("distill_stages", 3)),
            steps_per_stage=int(args.get("distill_steps", 1500)),
            lr=float(args.get("distill_lr", 1e-4)), w=0.5)
        students = progressive_distill(model, task_config, batches(), dcfg, log=log)
        m["distill"] = {}
        for n in sorted(students, reverse=True):
            s_d = twin.score("ddim_x0", n, model=students[n], w=0.0)
            s_u = twin.score("cfdg_ddim_x0", n)
            m["distill"][f"{n}steps"] = {
                "distilled_note_f1": round(s_d["note_f1"], 3),
                "distilled_frame_f1": round(s_d["frame_f1"], 3),
                "undistilled_note_f1": round(s_u["note_f1"], 3),
                "undistilled_frame_f1": round(s_u["frame_f1"], 3),
            }
            log(f"distilled@{n}: note {s_d['note_f1']:.3f} frame {s_d['frame_f1']:.3f} | "
                f"undistilled@{n}: note {s_u['note_f1']:.3f} frame {s_u['frame_f1']:.3f}")
    return m, twin


def over_seeds(rows: List[Dict]) -> Dict[str, Dict[str, Optional[float]]]:
    """The mean and the sample standard deviation (None for one row) of the
    rows' note and frame F1."""
    out = {}
    for k in ("note_f1", "frame_f1"):
        v = [r[k] for r in rows]
        out[k] = {"mean": float(np.mean(v)),
                  "sd": float(np.std(v, ddof=1)) if len(v) > 1 else None}
    return out


def clears_on_mean(rows: List[Dict], note_f1: float, frame_f1: float) -> bool:
    """Whether the mean note and frame F1 of the rows, one a seed, reach
    `note_f1` and `frame_f1`. No single row is held to them."""
    means = over_seeds(rows)
    return means["note_f1"]["mean"] >= note_f1 and means["frame_f1"]["mean"] >= frame_f1


def main(argv: Optional[List[str]] = None) -> Dict:
    m, _ = learning_check(parse_args(argv))
    print(json.dumps(m, indent=2))
    return m


if __name__ == "__main__":
    main()
