"""The port's learning check over seeds: `quality.synthetic_end_to_end`'s
`learning_check` at the JAX script's defaults (128 x 8 twin, 64 v2 clips,
2000 steps at lr 4e-4, B=8, 8 held-out clips scored by cfdg_ddpm_x0 at
w=0.5), run once per seed s: the weights drawn after `torch.manual_seed(s)`,
the training stream seeded s + 1, the clips rendered once. Seed 0 is the
check itself; `chip_smoke.py` phase `learn` gates the mean of such seeds.

    python tests/learning_seeds.py [seeds=0,1,2,3,4,5] [fused_train=1|0] [device=cuda|cpu] \
        [init=<a port .ckpt of the twin>] [<the check's other key=value options>]
    JAX_PLATFORMS=cpu python tests/learning_seeds.py jax [seeds=0,1,2,3,4,5]

With `init=` every seed starts from that checkpoint's weights (the JAX
script's own start is `tests/train_lockstep.py init trainer.seed=0`: the
p-sweep's twin is the script's) and only the training stream moves with the
seed. `jax` runs the JAX package's script recipe
(`examples/synthetic_end_to_end.py`, its clips, its draws) on the CPU
instead, the init from `jax.random.key(s)` and the stream from
`key(s + 1)`; seed 0 is the script itself.

The last stdout line is JSON: each seed's note and frame F1, their means and
standard deviations, and the device.
"""

from __future__ import annotations

import json
import pathlib
import sys
from typing import Dict, List, Optional

import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]


def jax_rows(seeds: List[int]) -> List[Dict]:
    """The JAX script's recipe per seed, on the CPU."""
    import importlib.util

    import jax

    from diffroll_tpu import models
    from diffroll_tpu.eval.evaluate import evaluate_rolls
    from diffroll_tpu.tasks import DiffusionTask, TaskConfig
    from diffroll_tpu.train import TrainState, make_optimizer, make_train_step

    jax.config.update("jax_platforms", "cpu")
    spec = importlib.util.spec_from_file_location(
        "jax_synthetic_end_to_end", REPO / "examples" / "synthetic_end_to_end.py")
    script = importlib.util.module_from_spec(spec)
    saved_argv, saved_path = sys.argv, list(sys.path)
    sys.argv = []
    try:
        spec.loader.exec_module(script)
    finally:
        sys.argv, sys.path[:] = saved_argv, saved_path
    train = [script.make_clip(i, "v2") for i in range(64)]
    test = [script.make_clip(1000 + i, "v2") for i in range(8)]
    train_audio, train_frame = (np.stack([c[j] for c in train]) for j in (0, 1))
    test_audio, test_frame = (np.stack([c[j] for c in test]) for j in (0, 1))
    model = models.build("ClassifierFreeDiffRoll", residual_channels=128, residual_layers=8,
                         frames=128, timesteps=100, spec_dropout=0.1)
    task = DiffusionTask(model, TaskConfig(timesteps=100, training_mode="x_0", loss_type="l2",
                                           lr=4e-4, sampling_type="cfdg_ddpm_x0", w=0.5))
    tx = make_optimizer(task.config.lr)
    step = make_train_step(task.loss_fn, tx, donate_state=False)
    sample = jax.jit(lambda p, x, k, wav: task.sample(p, x, k, waveform=wav)[0])
    rows = []
    for seed in seeds:
        state = TrainState.create(model.init(jax.random.key(seed)), tx)
        key = jax.random.key(seed + 1)
        for _ in range(2000):
            key, bk, sk = jax.random.split(key, 3)
            idx = np.asarray(jax.random.choice(bk, 64, (8,), replace=False))
            state, _ = step(state, {"frame": train_frame[idx], "audio": train_audio[idx]}, sk)
        _, nk, sk = jax.random.split(jax.random.key(7), 3)
        pred = sample(state.params, jax.random.normal(nk, (8, 128, 88)), sk, test_audio)
        m = evaluate_rolls(np.asarray(pred), test_frame, frame_threshold=0.5, hop_length=512,
                           sample_rate=16000)
        rows.append({"seed": seed, "note_f1": m["note_f1"], "frame_f1": m["frame_f1"]})
        print(json.dumps(rows[-1]), file=sys.stderr, flush=True)
    return rows


def main(argv: Optional[List[str]] = None) -> Dict:
    from diffroll_tpu_torch.compat import read_ckpt
    from diffroll_tpu_torch.quality import synthetic_end_to_end as se

    args = se.parse_args(argv)
    seeds = [int(x) for x in args.pop("seeds", "0,1,2,3,4,5").split(",")]
    if "jax" in (sys.argv[1:] if argv is None else argv):
        return summarise({"device": "cpu", "package": "jax"}, jax_rows(seeds))
    start = read_ckpt(args.pop("init"))["state_dict"] if "init" in args else None
    device = se.device_named(args.get("device", "cuda"))
    clips = se.check_clips(args, device)
    rows = []
    for seed in seeds:
        m, _ = se.learning_check(args, seed, clips, start)
        rows.append({"seed": seed, "note_f1": m["note_f1"], "frame_f1": m["frame_f1"]})
        se.log(json.dumps(rows[-1]))
    return summarise({"device": torch.cuda.get_device_name(0) if device.type == "cuda"
                      else "cpu", "package": "port", "fused_train": m["fused_train"]}, rows)


def summarise(summary: Dict, rows: List[Dict]) -> Dict:
    from diffroll_tpu_torch.quality.synthetic_end_to_end import over_seeds

    summary["rows"] = rows
    summary.update(over_seeds(rows))
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    main()
