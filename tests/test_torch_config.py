"""The port's configs, schedules, timestep grids, sampler tables and
override parser against the JAX package's, and the port's import surface
(no jax). Exact or float32-ulp equality throughout."""

import dataclasses
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from diffroll_tpu import config as jconfig
from diffroll_tpu import models as jmodels
from diffroll_tpu.config import experiment as jexperiment
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
from diffroll_tpu_torch import tasks as ttasks
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
            assert jax.numpy.dtype(jv).name == tv
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
    """The six configurations the first slices left unported (ROADMAP Queue 1
    items 19-21) now build, with the parameter names and shapes that
    `state_dict_from_jax` makes of the JAX package's init."""
    from diffroll_tpu_torch.compat import state_dict_from_jax

    kw = dict(residual_channels=16, residual_layers=2, frames=16, timesteps=10, **overrides)
    # the init's tree, traced without compiling it (15-20 s for a U-Net on a CPU)
    shapes = jax.eval_shape(jmodels.build(name, **kw).init, jax.random.key(0))
    params = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    want = {k: tuple(v.shape) for k, v in state_dict_from_jax(params).items()}
    got = {k: tuple(v.shape) for k, v in tmodels.build(name, **kw).net.state_dict().items()
           if not k.endswith("diffusion_embedding.embedding")}
    assert got == want


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
    # the names are blocked, so an import of any anywhere in the port raises
    # (the quality modules keep their own copies of the JAX scripts' renderers)
    code = (
        "import sys, importlib, pkgutil\n"
        "for name in ('jax', 'diffroll_tpu', 'examples', 'tools', 'synthetic_end_to_end'):\n"
        "    sys.modules[name] = None\n"
        "import diffroll_tpu_torch\n"
        "walked = [m.name for m in pkgutil.walk_packages(diffroll_tpu_torch.__path__,"
        " 'diffroll_tpu_torch.')]\n"
        "assert 'diffroll_tpu_torch.quality.synthetic_end_to_end' in walked, walked\n"
        "for name in walked:\n"
        "    importlib.import_module(name)\n"
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


# The trainer field of the JAX package that the port leaves out: the
# jax.random implementation.
TRAINER_LEFT_OUT = ("rng_impl",)
# The packed host-to-device batch formats are not ported: batches cross as float32.
DATALOADER_LEFT_OUT = ("transfer",)
# Every root field is ported; `device` is the port's own.
ROOT_LEFT_OUT = ()
# The XLA compilation cache has no counterpart in the port.
SERVE_LEFT_OUT = ("compile_cache_dir",)


@pytest.mark.parametrize("group,left_out", [
    ("DatasetConfig", ()), ("DataloaderConfig", DATALOADER_LEFT_OUT),
    ("TrainerConfig", TRAINER_LEFT_OUT), ("ServeConfig", SERVE_LEFT_OUT),
    ("DistillConfig", ()), ("BaselineConfig", ())])
def test_config_groups_match(group, left_out):
    port = getattr(tconfig, group, None) or getattr(ttasks, group)
    _assert_same_fields(getattr(jexperiment, group)(), port(), left_out)
    if group == "DatasetConfig":
        assert tconfig.DatasetConfig().audio_ext == "wav"


def test_serve_config_has_no_compile_cache():
    """The XLA compilation cache is not ported: no field, and the override
    that would set it is refused."""
    assert "compile_cache_dir" not in {f.name for f in dataclasses.fields(tconfig.ServeConfig)}
    with pytest.raises(KeyError, match="unknown config key"):
        tconfig.compose("sampling", {"serve.compile_cache_dir": "/tmp/cache"})
    cfg = tconfig.compose("sampling", {"serve.transfer": "float32", "serve.max_batch": "4"})
    assert cfg.serve.transfer == "float32" and cfg.serve.max_batch == 4


def _assert_same_experiment(j, t):
    jf = [f.name for f in dataclasses.fields(j) if f.name not in ROOT_LEFT_OUT]
    tf = [f.name for f in dataclasses.fields(t) if f.name != "device"]
    assert jf == tf
    assert j.model_name == t.model_name and j.pretrained_path == t.pretrained_path
    assert j.task_type == t.task_type
    _assert_same_fields(j.baseline, t.baseline)
    _assert_same_fields(j.distill, t.distill)
    assert j.dual == t.dual and t.device == "cuda"
    assert j.num_samples == t.num_samples and j.audio_format == t.audio_format
    _assert_same_fields(j.serve, t.serve, SERVE_LEFT_OUT)
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
    # every preset of the JAX package is there
    assert sorted(tconfig.PRESETS) == sorted(jconfig.PRESETS)
    _assert_same_experiment(jconfig.PRESETS[name], tconfig.PRESETS[name])
    # the transcription preset reads mp3 folders; the dataset default is wav
    assert tconfig.PRESETS["sampling"].dataset.audio_ext == "mp3"


@pytest.mark.parametrize("argv", [
    ["spec_roll", "model.kernel_size=9", "task.timesteps=50", "trainer.max_epochs=3"],
    ["unsupervised_pretrained", "dataset.root=/data", "trainer.ema_decay=0.999"],
    ["dual", "dataset2.name=MAESTRO", "dataset2.sequence_length=4096", "dual=true"],
    ["task.fused_train=true", "dataloader.train_batch_size=4", "pretrained_path=a.ckpt"],
    ["sampling", "dataset.audio_ext=wav", "task.w=0.3", "model_name=DiffRoll"],
    ["baseline", "baseline.lr=1e-4", "baseline.time_mode=random", "model.residual_layers=4"],
    ["distill.start_steps=9", "distill.stages=2", "distill.w=0.3", "task_type=baseline"],
    ["model.dtype=bfloat16", "trainer.adam_moments_dtype=bfloat16", "trainer.data_axis=2",
     "trainer.model_axis=1"],
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
    # the model's dtype: a jnp dtype there, its name here
    assert jax.numpy.dtype(jflat["model.dtype"]).name == tflat["model.dtype"]


def test_compose_rejects_unknown_names():
    with pytest.raises(KeyError, match="unknown config"):
        tconfig.compose("no_such_preset")
    with pytest.raises(KeyError):
        tconfig.compose("spec_roll", {"trainer.rng_impl": "rbg"})


def test_schedule_tables_are_float32():
    s = tschedule.linear_schedule(1e-4, 0.02, 200)
    assert all(getattr(s, f).dtype == torch.float32 for f in s._fields)
    assert s.timesteps == 200


# ---------------------------------------------------------- config=<file>.yaml

YAML = """\
task:
  w: 0.25
  sampling_steps: 20
  inpainting_t: [4, 12]
model:
  residual_layers: 6
trainer:
  max_epochs: 7
  run_name: from_file
distill:
  stages: 3
dataset:
  root: /from/file
"""


@pytest.mark.parametrize("argv", [
    [],
    ["task.w=0.75", "trainer.max_epochs=2"],
    ["spec_roll", "model.residual_layers=3", "distill.stages=1"],
    ["baseline", "dataset.root=/cli"],
])
def test_yaml_layering_matches_jax(tmp_path, argv):
    """`config=<file>.yaml` layers under the CLI keys, as in the JAX package:
    the same config and the same pinned overrides (the file's keys included,
    the CLI's winning)."""
    path = tmp_path / "exp.yaml"
    path.write_text(YAML)
    full = [*argv, f"config={path}"]
    jc, jrest, jover = jconfig.from_argv(full, "spec_roll")
    tc, trest, tover = tconfig.from_argv(full, "spec_roll")
    assert jrest == trest and jover == tover
    _assert_same_experiment(jc, tc)
    assert tover["config"] == str(path) and tover["trainer.run_name"] == "from_file"
    cli = dict(a.split("=", 1) for a in argv if "=" in a)
    assert tc.task.w == float(cli.get("task.w", 0.25))
    assert tc.trainer.max_epochs == int(cli.get("trainer.max_epochs", 7))
    assert tc.distill.stages == int(cli.get("distill.stages", 3))
    assert list(tc.task.inpainting_t) == [4, 12] and tc.task.sampling_steps == 20
    # compose alone takes the file too, under its other keys
    assert tconfig.compose("spec_roll", {"config": str(path), "task.w": "0.5"}).task.w == 0.5


def test_yaml_layering_without_pyyaml(tmp_path, monkeypatch):
    """PyYAML is imported only for `config=`: without it the port imports and
    composes, and `config=` stops with one clear error."""
    path = tmp_path / "exp.yaml"
    path.write_text(YAML)
    monkeypatch.setitem(sys.modules, "yaml", None)
    assert tconfig.from_argv(["task.w=0.5"], "spec_roll")[0].task.w == 0.5
    with pytest.raises(SystemExit, match="needs PyYAML"):
        tconfig.from_argv([f"config={path}"], "spec_roll")
