"""The port's configs, schedules, timestep grids, sampler tables and
override parser against the JAX package's, and the port's import surface
(no jax). Exact or float32-ulp equality throughout."""

import dataclasses
import subprocess
import sys

import numpy as np
import pytest
import torch

from diffroll_tpu import config as jconfig
from diffroll_tpu import models as jmodels
from diffroll_tpu.config import overrides as joverrides
from diffroll_tpu.config.experiment import asdict_flat as j_asdict_flat
from diffroll_tpu.diffusion import loop as jloop
from diffroll_tpu.diffusion import schedule as jschedule
from diffroll_tpu.diffusion.samplers import SAMPLER_TABLE as J_SAMPLERS
from diffroll_tpu.dsp.mel import MelConfig as JMelConfig
from diffroll_tpu.ops.sampler_kernel import sampler_tables as j_tables
from diffroll_tpu.tasks.diffusion import TaskConfig as JTaskConfig
from diffroll_tpu_torch import config as tconfig
from diffroll_tpu_torch import models as tmodels
from diffroll_tpu_torch.config import overrides as toverrides
from diffroll_tpu_torch.diffusion import loop as tloop
from diffroll_tpu_torch.diffusion import schedule as tschedule
from diffroll_tpu_torch.diffusion.samplers import SAMPLER_TABLE as T_SAMPLERS
from diffroll_tpu_torch.dsp.mel import MelConfig as TMelConfig
from diffroll_tpu_torch.ops.sampler_kernel import sampler_tables as t_tables
from diffroll_tpu_torch.tasks.diffusion import TaskConfig as TTaskConfig

torch.set_num_threads(1)


def _assert_same_fields(j, t, left_out=()):
    """Same fields in the same order with the same values; `left_out` names
    the JAX fields the port does not carry yet."""
    jf = [f.name for f in dataclasses.fields(j) if f.name not in left_out]
    assert set(left_out) <= {f.name for f in dataclasses.fields(j)}
    assert jf == [f.name for f in dataclasses.fields(t)]
    for name in jf:
        jv, tv = getattr(j, name), getattr(t, name)
        if name == "dtype":
            assert np.dtype(jv).name == tv
        elif name == "mel":
            assert dataclasses.asdict(jv) == dataclasses.asdict(tv)
        else:
            assert jv == tv, name


@pytest.mark.parametrize("name", sorted(jmodels.PRESETS))
def test_presets_match(name):
    assert sorted(tmodels.PRESETS) == sorted(jmodels.PRESETS)
    j, t = jmodels.PRESETS[name], tmodels.PRESETS[name]
    _assert_same_fields(j, t)
    assert j.dilations() == t.dilations()


def test_mel_and_task_configs_match():
    _assert_same_fields(JMelConfig(), TMelConfig())
    _assert_same_fields(JTaskConfig(), TTaskConfig())
    assert TMelConfig().num_frames(327680) == JMelConfig().num_frames(327680) == 641


@pytest.mark.parametrize("name,overrides", [
    ("DiffRollv2", {}), ("DiffRollv2Debug", {}), ("Unet", {}), ("SpecUnet", {}),
    ("ClassifierFreeDiffRoll", {"condition": "trainable_spec"}),
    ("ClassifierFreeDiffRoll", {"condition": "trainable_z"}),
])
def test_unported_variants_name_their_roadmap_item(name, overrides):
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item"):
        tmodels.build(name, residual_channels=16, residual_layers=2, **overrides)


@pytest.mark.parametrize("kind", ["linear", "cosine", "quadratic", "sigmoid"])
def test_beta_schedules_match(kind):
    T = 200
    if kind == "linear":
        j = jschedule.linear_beta_schedule(1e-4, 0.02, T)
        t = tschedule.linear_beta_schedule(1e-4, 0.02, T)
    else:
        j = getattr(jschedule, f"{kind}_beta_schedule")(T)
        t = getattr(tschedule, f"{kind}_beta_schedule")(T)
    # float32 on both sides: XLA and ATen round linspace/cos/sigmoid a few
    # ulps apart (measured <= 2.4e-7 abs on the betas)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-6)
    js = jschedule.make_schedule(j)
    ts = tschedule.make_schedule(torch.tensor(np.asarray(j)))
    # from the same betas: the two cumulative products associate
    # differently (<= 4.2e-7 rel measured), which the cancellation in
    # 1 - acum near t=0 amplifies to <= 1.7e-6 abs in sqrt(1 - acum)
    for field in jschedule.Schedule._fields:
        np.testing.assert_allclose(getattr(ts, field).numpy(), np.asarray(getattr(js, field)),
                                   rtol=1e-6, atol=5e-6, err_msg=field)


@pytest.mark.parametrize("T,steps", [(200, None), (200, 50), (200, 7), (12, 5), (10, 1),
                                     (16, 40)])
def test_timestep_subsequence_matches(T, steps):
    np.testing.assert_array_equal(tloop.timestep_subsequence(T, steps),
                                  jloop.timestep_subsequence(T, steps))


@pytest.mark.parametrize("name", sorted(J_SAMPLERS))
@pytest.mark.parametrize("steps", [None, 6])
def test_sampler_tables_match(name, steps):
    T = 16
    # one schedule for both (its f32 differences are test_beta_schedules_match's)
    sched = jschedule.linear_schedule(1e-4, 0.02, T)
    ts = jloop.timestep_subsequence(T, steps)
    tsp = np.concatenate([ts[1:], [-1]]).astype(np.int32)
    np.testing.assert_allclose(t_tables(sched, name, ts, tloop.previous_timesteps(ts)),
                               j_tables(sched, name, ts, tsp), atol=1e-6, rtol=0)
    assert J_SAMPLERS[name][1:] == T_SAMPLERS[name][1:]


@pytest.mark.parametrize("value,annotation", [
    ("0.5", float), ("null", "Optional[int]"), ("[100,200]", "Optional[Sequence[int]]"),
    ("true", bool), ("cfdg_ddim_x0", str), ("(0.0, 1.0, imagewise)",
                                            "Tuple[float, float, str]"),
])
def test_override_coercion_matches(value, annotation):
    from typing import Optional, Sequence, Tuple  # noqa: F401 (eval namespace)

    ann = eval(annotation) if isinstance(annotation, str) else annotation
    assert toverrides.coerce(value, ann) == joverrides.coerce(value, ann)


def test_apply_overrides_over_port_configs():
    cfg = toverrides.apply_overrides(
        TTaskConfig(), {"w": "0.5", "sampling_steps": "20", "inpainting_t": "[4,12]"})
    assert cfg.w == 0.5 and cfg.sampling_steps == 20 and cfg.inpainting_t == (4, 12)
    with pytest.raises(KeyError, match="unknown config key"):
        toverrides.apply_overrides(TTaskConfig(), {"nope": "1"})


def test_port_imports_no_jax():
    # both names are blocked, so an import of either anywhere in the port raises
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['diffroll_tpu'] = None\n"
        "import diffroll_tpu_torch\n"
        "for m in pkgutil.walk_packages(diffroll_tpu_torch.__path__, 'diffroll_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import diffroll_tpu_torch.__main__\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in ('jax', 'flax', 'optax',"
        " 'diffroll_tpu') and sys.modules[k] is not None]\n"
        "assert not bad, bad\n"
        "print('ok', len(list(pkgutil.walk_packages(diffroll_tpu_torch.__path__))))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


# The trainer fields of the JAX package that the port leaves out (the mesh
# axes, the jax.random implementation and the bf16 Adam moments).
TRAINER_LEFT_OUT = ("model_axis", "data_axis", "rng_impl", "adam_moments_dtype")
# The packed host-to-device batch formats are not ported: batches cross as float32.
DATALOADER_LEFT_OUT = ("transfer",)
# Root fields of slices that are not ported yet; `device` is the port's own.
ROOT_LEFT_OUT = ("task_type", "baseline", "serve", "distill", "num_samples", "audio_format")


@pytest.mark.parametrize("group,left_out", [
    ("DatasetConfig", ()), ("DataloaderConfig", DATALOADER_LEFT_OUT),
    ("TrainerConfig", TRAINER_LEFT_OUT)])
def test_config_groups_match(group, left_out):
    _assert_same_fields(getattr(jconfig, group)(), getattr(tconfig, group)(), left_out)
    if group == "DatasetConfig":
        assert tconfig.DatasetConfig().audio_ext == "wav"


def _assert_same_experiment(j, t):
    jf = [f.name for f in dataclasses.fields(j) if f.name not in ROOT_LEFT_OUT]
    tf = [f.name for f in dataclasses.fields(t) if f.name != "device"]
    assert jf == tf
    assert j.model_name == t.model_name and j.pretrained_path == t.pretrained_path
    assert j.dual == t.dual and t.device == "cuda"
    _assert_same_fields(j.model, t.model)
    _assert_same_fields(j.task, t.task)
    _assert_same_fields(j.dataset, t.dataset)
    _assert_same_fields(j.dataloader, t.dataloader, DATALOADER_LEFT_OUT)
    _assert_same_fields(j.trainer, t.trainer, TRAINER_LEFT_OUT)
    assert (j.dataset2 is None) == (t.dataset2 is None)
    if j.dataset2 is not None:
        _assert_same_fields(j.dataset2, t.dataset2)
    assert j.describe() == t.describe()


def test_experiment_defaults_match():
    _assert_same_experiment(jconfig.ExperimentConfig(), tconfig.ExperimentConfig())


@pytest.mark.parametrize("name", sorted(tconfig.PRESETS))
def test_experiment_presets_match(name):
    # every preset of the JAX package but the baseline task's is there
    assert sorted(tconfig.PRESETS) == sorted(set(jconfig.PRESETS) - {"baseline"})
    _assert_same_experiment(jconfig.PRESETS[name], tconfig.PRESETS[name])
    # the transcription preset reads mp3 folders; the dataset default is wav
    assert tconfig.PRESETS["sampling"].dataset.audio_ext == "mp3"


@pytest.mark.parametrize("argv", [
    ["spec_roll", "model.kernel_size=9", "task.timesteps=50", "trainer.max_epochs=3"],
    ["unsupervised_pretrained", "dataset.root=/data", "trainer.ema_decay=0.999"],
    ["dual", "dataset2.name=MAESTRO", "dataset2.sequence_length=4096", "dual=true"],
    ["task.fused_train=true", "dataloader.train_batch_size=4", "pretrained_path=a.ckpt"],
    ["sampling", "dataset.audio_ext=wav", "task.w=0.3", "model_name=DiffRoll"],
])
def test_from_argv_matches(argv):
    jc, jrest, jover = jconfig.from_argv(argv, "spec_roll")
    tc, trest, tover = tconfig.from_argv(argv, "spec_roll")
    assert jrest == trest and jover == tover
    _assert_same_experiment(jc, tc)
    assert tc.model.timesteps == tc.task.timesteps
    jflat, tflat = j_asdict_flat(jc), tconfig.asdict_flat(tc)
    shared = [k for k in tflat if k in jflat and k != "model.dtype"]
    assert len(shared) > 60 and all(jflat[k] == tflat[k] for k in shared)


def test_compose_rejects_unknown_names():
    with pytest.raises(KeyError, match="unknown config"):
        tconfig.compose("baseline")
    with pytest.raises(KeyError):
        tconfig.compose("spec_roll", {"trainer.model_axis": "2"})


def test_schedule_tables_are_float32():
    s = tschedule.linear_schedule(1e-4, 0.02, 200)
    assert all(getattr(s, f).dtype == torch.float32 for f in s._fields)
    assert s.timesteps == 200
