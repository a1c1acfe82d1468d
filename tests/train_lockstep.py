"""Both packages' training in lockstep on the CPU: the JAX package's
`train` and the port's `train` on one tree, from the same initial weights,
on the same batches and the same draws, for a whole recipe.

    JAX_PLATFORMS=cpu python tests/train_lockstep.py dataset.root=<MAPS tree> \\
        [out=outputs/train_lockstep] [<the recipe's key=value ...>]
    JAX_PLATFORMS=cpu python tests/train_lockstep.py init [out=...] [trainer.seed=<s> ...]

The recipe defaults to the p-sweep's p=0.1 point (`paper_sweeps.MODEL` and
`COMMON`, 84 epochs validated every 21, `model.spec_dropout=0.1`,
`trainer.seed=0`); dotted keys after it override it in both packages.

  1. The JAX `train` runs as it is (`diffroll_tpu.cli.train.main` on the
     CPU backend), its step functions wrapped to keep, in order, each
     train step's and each validation batch's key, its initial weights, a
     checksum of every batch, and its weights after the steps of `SNAPS`.
  2. The initial weights become a port checkpoint (`compat.state_dict_from_jax`,
     step 0, no optimizer state), and the port's `train` starts from it
     (`pretrained_path=`: a fresh Adam at step 0) with `device=cpu`. Its step
     functions are wrapped so that each call of its `loss_fn` hands over the
     t, noise and dropout mask that the JAX `loss_fn` drew from the same
     call's key (`jax.random.split(key, 3)`, as `diffroll_tpu/tasks/diffusion.py`
     does; computed while the JAX run goes, kept as arrays), validation
     included; the same checksums and weights are kept.
  3. Both runs' `last` checkpoints are written under `<out>/ckpts/` as port
     `.ckpt` files named for `tests/inpainting_seeds.py score`
     (`jax_cpu_s<seed>_lockstep.ckpt`, `port_cpu_s<seed>_lockstep.ckpt`).

`init` only writes the JAX `train`'s initial weights of the recipe (its
`model.init(jax.random.key(trainer.seed))`) as `<out>/init_s<seed>.ckpt`, a
port checkpoint at step 0 that `train pretrained_path=` (and
`tests/inpainting_seeds.py train init=<out>`) starts from on any device.

`<out>/lockstep.json` and the last stdout line: whether every batch was the
same, the largest parameter difference (and that over the largest JAX
parameter) at each step of `SNAPS`, the steps each package saved, and both
post-fit test scores. The run takes the two trainings' time on the CPU (the
JAX package's ~3.5 min and the port's); run nothing else on the cores.
"""

from __future__ import annotations

import json
import pathlib
import sys
from typing import Dict, List, Optional

import numpy as np

REPO = pathlib.Path(__file__).resolve().parents[1]
SNAPS = (1, 24, 504, 1008, 2016)


def recipe(args: Dict[str, str]) -> List[str]:
    from diffroll_tpu_torch.quality import paper_sweeps

    base = ["spec_roll", *paper_sweeps.MODEL, *paper_sweeps.COMMON, "trainer.max_epochs=84",
            "trainer.check_val_every_n_epoch=21", "model.spec_dropout=0.1", "trainer.seed=0"]
    return base + [f"{k}={v}" for k, v in args.items() if "." in k]


def setting(argv: List[str], key: str) -> int:
    """The last integer value `argv` gives `key`."""
    return next(int(a.split("=", 1)[1]) for a in reversed(argv) if a.startswith(key + "="))


def checksum(frame, audio) -> List[float]:
    return [float(np.asarray(frame, np.float64).sum()), float(np.asarray(audio, np.float64).sum())]


def recording_saves(cls, saves: List[int]) -> None:
    """Record each monitored save of a `Checkpointer` class."""
    save = cls.save

    def rec(self, step, *a, **kw):
        saves.append(int(step))
        return save(self, step, *a, **kw)

    cls.save = rec


def run_jax(argv: List[str], out: pathlib.Path) -> Dict:
    import jax

    from diffroll_tpu.cli import train as train_cli
    from diffroll_tpu.train import loop
    from diffroll_tpu.train.checkpoint import Checkpointer
    from diffroll_tpu_torch.compat import state_dict_from_jax

    rec = {"draws": [], "batches": [], "snaps": {}, "saves": []}
    make_train, make_eval = loop.make_train_step, loop.make_eval_step

    def weights(params):
        return {k: v.numpy() for k, v in state_dict_from_jax(
            jax.tree.map(np.asarray, params)).items()}

    def kept_draws(loss_fn, key, frame, train):
        task = loss_fn.__self__
        return draws(key, tuple(frame.shape), task.config.timesteps,
                     task.model.config.spec_dropout, train)

    def train_step(loss_fn, *a, **kw):
        step = make_train(loss_fn, *a, **kw)

        def keep(state, batch, key):
            if not rec["draws"]:
                rec["init"] = jax.tree.map(np.array, state.params)
            rec["draws"].append(("train", kept_draws(loss_fn, key, batch["frame"], True)))
            rec["batches"].append(checksum(batch["frame"], batch["audio"]))
            state, losses = step(state, batch, key)
            n = len(rec["batches"])
            if n in SNAPS:
                rec["snaps"][n] = weights(state.params)
            return state, losses
        return keep

    def eval_step(loss_fn, *a, **kw):
        step = make_eval(loss_fn, *a, **kw)

        def keep(params, batch, key):
            rec["draws"].append(("eval", kept_draws(loss_fn, key, batch["frame"], False)))
            return step(params, batch, key)
        return keep

    loop.make_train_step, loop.make_eval_step = train_step, eval_step
    recording_saves(Checkpointer, rec["saves"])
    jax.config.update("jax_platforms", "cpu")   # as `python -m diffroll_tpu ... platform=cpu`
    train_cli.main([*argv, f"trainer.output_dir={out / 'jax'}"])
    return rec


def draws(key, shape, timesteps: int, p: float, train: bool) -> Dict:
    """The t, noise and dropout mask the JAX `loss_fn` draws from `key` for a
    roll of `shape`, as numpy arrays (no mask outside training)."""
    import jax
    import jax.numpy as jnp

    t_key, n_key, d_key = jax.random.split(key, 3)
    t = jax.random.randint(t_key, shape[:1], 0, timesteps)
    noise = jax.random.normal(n_key, shape, jnp.float32)
    mask = jax.random.bernoulli(d_key, p, shape[:1]) if train and p > 0 else None
    return {"t": np.array(t), "noise": np.array(noise),
            "mask": None if mask is None else np.array(mask)}


def init_ckpt(argv: List[str], params, dst: pathlib.Path) -> None:
    """JAX initial weights `params` as a port checkpoint of the recipe
    `argv` at step 0, with no optimizer state: `train pretrained_path=<dst>`
    starts from them with a fresh Adam."""
    import torch

    from diffroll_tpu_torch.cli import _common
    from diffroll_tpu_torch.compat import state_dict_from_jax
    from diffroll_tpu_torch.config import from_argv
    from diffroll_tpu_torch.train.checkpoint import hyper_parameters

    cfg, _, _ = from_argv([*argv, "device=cpu"], "spec_roll")
    torch.save({"state_dict": state_dict_from_jax(params),
                "hyper_parameters": hyper_parameters(_common.config_record(cfg)),
                "global_step": 0}, dst)


def jax_init(argv: List[str]):
    """The weights the JAX `train` starts the recipe `argv` from:
    `model.init(jax.random.key(trainer.seed))`."""
    import jax

    from diffroll_tpu.cli import _common
    from diffroll_tpu.config import from_argv

    jax.config.update("jax_platforms", "cpu")
    cfg, _, _ = from_argv(argv, "spec_roll")
    model, _ = _common.setup_model_task(cfg)
    return jax.tree.map(np.asarray, model.init(jax.random.key(cfg.trainer.seed)))


def run_port(argv: List[str], jax_rec: Dict, out: pathlib.Path) -> Dict:
    import torch

    from diffroll_tpu_torch.cli import train as train_cli
    from diffroll_tpu_torch.train import loop
    from diffroll_tpu_torch.train.checkpoint import Checkpointer

    init = out / "init.ckpt"
    init_ckpt(argv, jax_rec["init"], init)
    rec = {"batches": [], "snaps": {}, "saves": []}
    jax_draws = iter(jax_rec["draws"])

    def replay(loss_fn):
        def fn(batch, generator, train):
            kind, d = next(jax_draws)
            if kind != ("train" if train else "eval"):
                raise RuntimeError(f"the JAX run made a {kind} call here; "
                                   "the port made the other kind")
            given = {kw: None if d[stream] is None else torch.from_numpy(d[stream])
                     for stream, kw in (("t", "t"), ("noise", "noise"), ("mask", "uncond_mask"))}
            return loss_fn(batch, generator, train, **given)
        return fn

    make_train, make_eval = loop.make_train_step, loop.make_eval_step

    def train_step(loss_fn, mesh=None):
        step = make_train(replay(loss_fn), mesh)

        def keep(state, batch, generator):
            rec["batches"].append(checksum(batch["frame"].numpy(), batch["audio"].numpy()))
            losses = step(state, batch, generator)
            if state.step in SNAPS:
                rec["snaps"][state.step] = {n: p.detach().numpy().copy()
                                            for n, p in state.model.net.named_parameters()}
            return losses
        return keep

    loop.make_train_step = train_step
    loop.make_eval_step = lambda loss_fn: make_eval(replay(loss_fn))
    recording_saves(Checkpointer, rec["saves"])
    torch.set_num_threads(8)
    train_cli.main([*argv, f"pretrained_path={init}", "device=cpu",
                    f"trainer.output_dir={out / 'port'}"])
    if next(jax_draws, None) is not None:
        raise RuntimeError("the port used fewer draws than the JAX run")
    return rec


def last_scores(run: pathlib.Path) -> Dict:
    return json.loads(sorted(run.rglob("test_metrics.json"))[-1].read_text())


def main(argv: Optional[List[str]] = None) -> Dict:
    argv = sys.argv[1:] if argv is None else argv
    args = dict(a.split("=", 1) for a in argv if "=" in a)
    out = pathlib.Path(args.get("out", "outputs/train_lockstep"))
    out.mkdir(parents=True, exist_ok=True)
    run = recipe({k: v for k, v in args.items() if k != "out"})
    seed = setting(run, "trainer.seed")
    if "init" in argv:
        dst = out / f"init_s{seed}.ckpt"
        init_ckpt(run, jax_init(run), dst)
        print(json.dumps({"init": str(dst)}))
        return {"init": str(dst)}
    (out / "ckpts").mkdir(exist_ok=True)

    jrec = run_jax(run, out)
    prec = run_port(run, jrec, out)

    from inpainting_cross_score import export_port_ckpt, jax_checkpoint
    from inpainting_seeds import slim_copy

    diffs = {}
    for step, ref in jrec["snaps"].items():
        got = prec["snaps"][step]
        worst = max(float(np.abs(got[n] - r).max()) for n, r in ref.items())
        diffs[step] = {"max_abs": worst,
                       "rel": worst / max(float(np.abs(r).max()) for r in ref.values())}
    jax_dir = sorted((out / "jax").rglob("checkpoints"))[-1]
    export_port_ckpt(jax_checkpoint(str(jax_dir), "last", out), setting(run, "model.frames"),
                     out / "ckpts" / f"jax_cpu_s{seed}_lockstep.ckpt")
    port_dir = sorted((out / "port").rglob("checkpoints"))[-1]
    slim_copy(port_dir / "last.ckpt", out / "ckpts" / f"port_cpu_s{seed}_lockstep.ckpt")
    summary = {"steps": len(jrec["batches"]),
               "same_batches": jrec["batches"] == prec["batches"],
               "param_diff": diffs, "saves": {"jax": jrec["saves"], "port": prec["saves"]},
               "post_fit": {"jax": last_scores(out / "jax"), "port": last_scores(out / "port")}}
    (out / "lockstep.json").write_text(json.dumps(summary, indent=2))
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(REPO / "tests"))
    main()
