"""The port's trainable conditioning (`condition=trainable_spec`,
`trainable_z`) and its 2-D DiffRollv2 family against the JAX package on the
CPU, on the same weights (through `state_dict_from_jax`), inputs and draws:

  * the forward with a mixed `uncond_mask`, `apply_cfg` and the per-layer
    conditioner projections: atol 1e-4, rtol 1e-3;
  * the task's loss (1e-5) and every parameter gradient (max|d| / max|ref| <
    2e-3), with the JAX `loss_fn`'s draws handed to the port;
  * a 10-step guided trajectory against the JAX scan path, x_T and the
    per-step noise passed in: rel < 1e-3;
  * the reference layouts: `trainable_parameters` (n_mels, spec_frames) and
    `uncon_z` (2C, frames), and a hand-built reference 2-D state dict whose
    asymmetric kernel shows which spatial axis is which;
  * the `train` entry on `model_name=DiffRollv2` and on
    `model.condition=trainable_spec`, with the validation figures.

Sizes: C=8, 3 layers, 16 frames, 10 timesteps.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffroll_tpu import models as jmodels
from diffroll_tpu.compat import convert_state_dict
from diffroll_tpu.tasks import DiffusionTask as JTask
from diffroll_tpu.tasks import TaskConfig as JTaskConfig
from diffroll_tpu_torch import models as tmodels
from diffroll_tpu_torch.cli import train as train_cli
from diffroll_tpu_torch.compat import grads_from_jax, load_lightning, state_dict_from_jax
from diffroll_tpu_torch.tasks import DiffusionTask as TTask
from diffroll_tpu_torch.tasks import TaskConfig as TTaskConfig
from diffroll_tpu_torch.viz import param_heatmaps
from diffroll_tpu.viz import param_heatmaps as j_param_heatmaps
from test_torch_train_cli import TINY, _write_tree  # the synthetic MAPS tree

torch.set_num_threads(1)
ATOL, RTOL, F32_GATE = 1e-4, 1e-3, 1e-3
LOSS_TOL, GRAD_GATE = 1e-5, 2e-3
C, L, T, B, STEPS = 8, 3, 16, 4, 10
CONFIGS = {
    "trainable_spec": ("ClassifierFreeDiffRoll", {"condition": "trainable_spec"}),
    "trainable_z": ("ClassifierFreeDiffRoll", {"condition": "trainable_z"}),
    # dilations 1, 2, 4 (the preset's are all 1) to cover the 2-D padding
    "v2": ("DiffRollv2", {"dilation_base": 2, "dilation_bound": 3}),
    "v2debug": ("DiffRollv2Debug", {}),
}


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-5))


def jax_params(jm, seed=0):
    """Seeded values in the tree that `jm.init` builds (the same names and
    shapes: `jax.eval_shape` traces init without compiling it, which takes
    4 s for these nets on the CPU and 15-20 s for a U-Net). Kernels scaled
    by 1 / sqrt(fan-in); none is zero, the heads included, so every gradient
    is non-trivial; the learned spectrogram sits around its init of -1."""
    rng = np.random.default_rng(seed)

    def fill(path, shape):
        z = rng.standard_normal(shape.shape).astype(np.float32)
        leaf = path[-1].key
        if leaf == "kernel":
            return z / np.sqrt(np.prod(shape.shape[:-1]))
        if leaf == "scale":
            return 1.0 + 0.1 * z
        if leaf == "trainable_parameters":
            return -1.0 + 0.3 * z
        return 0.1 * z

    shapes = jax.eval_shape(jm.init, jax.random.key(0))
    return jax.tree_util.tree_map_with_path(lambda p, s: jnp.asarray(fill(p, s)), shapes)


@functools.lru_cache(maxsize=None)
def _pair(key):
    name, extra = CONFIGS[key]
    kw = dict(residual_channels=C, residual_layers=L, frames=T, timesteps=STEPS,
              spec_dropout=0.5, **extra)
    jm = jmodels.build(name, **kw)
    params = jax_params(jm)
    tm = tmodels.build(name, **kw)
    tm.net.load_state_dict(state_dict_from_jax(params))
    return jm, params, tm


def _cond(jm, rng, b=B):
    n = jm.config.n_mels if jm.config.cond_source == "spec" else 88
    return rng.random((b, T, n)).astype(np.float32)


@pytest.mark.parametrize("key", sorted(CONFIGS))
def test_forward_and_cfg_match(key):
    """Both guidance branches in one 2B forward (rows [B, 2B) unconditional),
    the port's forward on those rows with the mixed mask given explicitly,
    and the per-layer projected conditioners."""
    jm, params, tm = _pair(key)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, T, 88)).astype(np.float32)
    t = rng.integers(0, STEPS, size=B).astype(np.int32)
    cond = _cond(jm, rng)
    jc, ju = jax.jit(jm.apply_cfg)(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(cond))
    jproj = jax.jit(jm.cfg_cond_projections)(params, jnp.asarray(cond))
    tx, tt, tc = torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(cond)
    tm.eval()
    with torch.no_grad():
        mask = torch.arange(2 * B) >= B
        mixed = tm.apply(torch.cat([tx, tx]), torch.cat([tt, tt]), torch.cat([tc, tc]), mask)
        pc, pu = tm.apply_cfg(tx, tt, tc)
        proj = tm.cfg_cond_projections(tc)
        pc2, pu2 = tm.apply_cfg(tx, tt, cond_proj=proj)
    assert np.abs(np.asarray(jc)).max() > 0.1
    # unconditional rows differ from conditional ones: the substitute is used
    assert not np.allclose(np.asarray(jc), np.asarray(ju), atol=1e-3)
    for a, b in [(mixed[:B], jc), (mixed[B:], ju), (pc, jc), (pu, ju), (pc2, jc), (pu2, ju)]:
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, rtol=RTOL)
    for a, b in zip(proj, jproj):
        b = np.asarray(b)
        if a.ndim == 4:  # 2-D: the port's (B, 2C, 88, T) against JAX's (B, T, 88, 2C)
            b = b.transpose(0, 3, 2, 1)
        np.testing.assert_allclose(a.numpy(), b, atol=ATOL, rtol=RTOL)


def _jax_draws(key, p):
    t_key, n_key, d_key = jax.random.split(key, 3)
    t = jax.random.randint(t_key, (B,), 0, STEPS)
    noise = jax.random.normal(n_key, (B, T, 88), jnp.float32)
    mask = jax.random.bernoulli(d_key, p, (B,))
    return (torch.from_numpy(np.array(t)), torch.from_numpy(np.array(noise)),
            torch.from_numpy(np.array(mask)))


def compare_loss_and_grads(jm, params, tm, kw, key, batch):
    """The JAX task's loss and gradients against the port's on the same
    draws (the timesteps, the noise and the spec-dropout mask the JAX
    `loss_fn` draws from `key`); returns the mask and the port's gradients
    (None where a parameter takes no part in the loss)."""
    jtask, ttask = JTask(jm, JTaskConfig(**kw)), TTask(tm, TTaskConfig(**kw))
    (jtotal, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jtask.loss_fn(p, {k: jnp.asarray(v) for k, v in batch.items()}, key, True),
        has_aux=True))(params)
    t, noise, mask = _jax_draws(key, jm.config.spec_dropout)
    tm.train()
    tm.net.zero_grad(set_to_none=True)
    ttotal, _ = ttask.loss_fn({k: torch.from_numpy(v) for k, v in batch.items()},
                                         None, True, t=t, noise=noise, uncond_mask=mask)
    ttotal.backward()
    assert abs(float(ttotal.detach()) - float(jtotal)) < LOSS_TOL
    want = grads_from_jax(jax.tree.map(np.asarray, jgrads))
    got = {n: p.grad for n, p in tm.net.named_parameters()}
    assert sorted(want) == sorted(got)
    for name, ref in want.items():
        g = torch.zeros_like(ref) if got[name] is None else got[name]
        assert g.shape == ref.shape, name
        assert rel(g, ref) < GRAD_GATE, name
    return mask, got


@pytest.mark.parametrize("key", sorted(CONFIGS))
def test_loss_and_grads_match(key):
    jm, params, tm = _pair(key)
    rng = np.random.default_rng(2)
    batch = {"frame": (rng.random((B, T, 88)) > 0.8).astype(np.float32),
             "audio": (0.1 * rng.standard_normal((B, T * 512))).astype(np.float32)}
    mask, got = compare_loss_and_grads(jm, params, tm, dict(timesteps=STEPS), jax.random.key(3),
                                       batch)
    assert 0 < int(mask.sum()) < B  # both kinds of row
    # the learned substitutes take gradient from the unconditional rows
    for name in ("trainable_parameters", "residual_layers.0.uncon_z"):
        if name in got:
            assert float(got[name].abs().max()) > 0, name


def jax_noise(key, n, shape):
    """The JAX scan's per-step draws (one split key per step)."""
    keys = jax.random.split(key, n)
    return np.array(jax.vmap(lambda k: jax.random.normal(k, shape))(keys))


@pytest.mark.parametrize("key,sampler", [
    *((k, "cfdg_ddpm_x0") for k in sorted(CONFIGS)),
    # from noise alone: every row unconditional, so the learned substitutes
    ("trainable_spec", "generation_ddpm_x0"), ("trainable_z", "generation_ddpm_x0"),
])
def test_trajectory_matches_jax_scan(key, sampler):
    jm, params, tm = _pair(key)
    rng = np.random.default_rng(4)
    b = 2
    x_T = rng.standard_normal((b, T, 88)).astype(np.float32)
    generation = sampler.startswith("generation")
    wav = None if generation else (0.1 * rng.standard_normal((b, T * 512))).astype(np.float32)
    roll = _cond(jm, rng, b) if jm.config.cond_source == "roll" else None
    key = jax.random.key(5)
    cfg = dict(timesteps=STEPS, sampling_type=sampler, w=0.5)
    j0, jtraj = JTask(jm, JTaskConfig(use_megakernel=False, **cfg)).sample(
        params, jnp.asarray(x_T), key, waveform=None if wav is None else jnp.asarray(wav),
        roll_cond=None if roll is None else jnp.asarray(roll), record_every=5)
    tm.eval()
    t0, ttraj = TTask(tm, TTaskConfig(**cfg)).sample(
        torch.from_numpy(x_T), waveform=None if wav is None else torch.from_numpy(wav),
        roll_cond=None if roll is None else torch.from_numpy(roll),
        noise=torch.from_numpy(jax_noise(key, STEPS, x_T.shape)), record_every=5)
    assert ttraj.shape == np.asarray(jtraj).shape == (2, b, T, 88)
    assert rel(ttraj.numpy(), jtraj) < F32_GATE and rel(t0.numpy(), j0) < F32_GATE


def test_learned_substitutes_keep_the_reference_layout():
    """`trainable_parameters` is (n_mels, spec_frames), initialised to -1, and
    `uncon_z` (2C, frames), as the reference stores them: the JAX package's
    reference loader reads the port's state_dict back to the JAX params."""
    for key, shapes in (("trainable_spec", {"trainable_parameters": (229, 17)}),
                        ("trainable_z", {f"residual_layers.{i}.uncon_z": (2 * C, T)
                                         for i in range(L)})):
        jm, params, tm = _pair(key)
        sd = tm.net.state_dict()
        for name, shape in shapes.items():
            assert tuple(sd[name].shape) == shape, name
        back = convert_state_dict(state_dict_from_jax(params))
        for path, leaf in jax.tree_util.tree_leaves_with_path(params["params"]):
            node = back
            for k in path:
                node = node[k.key]
            np.testing.assert_array_equal(node, np.asarray(leaf))
    fresh = tmodels.build("ClassifierFreeDiffRoll", residual_channels=C, residual_layers=L,
                          frames=T, condition="trainable_spec").net
    assert bool((fresh.trainable_parameters == -1.0).all())


def test_reference_2d_state_dict_loads_in_the_reference_layout(tmp_path):
    """A reference DiffRollv2 checkpoint, built by hand: its Conv2d weights are
    (O, I, k88, kT) over (B, C, 88, T). One nonzero tap at (k88=0, kT=2) moves
    an impulse up one key and back one frame in the port. The JAX package's
    reference loader reads the same weight as (kT, k88): it moves the impulse
    up one frame and back one key (ROADMAP Queue 3)."""
    cfg = dict(residual_channels=1, residual_layers=1, frames=T, timesteps=STEPS)
    tm = tmodels.build("DiffRollv2", **cfg)
    sd = {k: torch.zeros_like(v) for k, v in tm.net.state_dict().items()}
    sd["residual_layers.0.dilated_conv.weight"][1, 0, 0, 2] = 1.0  # the filter half
    sd["residual_layers.0.output_projection.weight"][1, 0, 0, 0] = 1.0  # skip := g
    sd["input_projection.weight"][0, 0, 0, 0] = 1.0
    sd["input_projection.bias"][0] = 0.0
    sd["skip_projection.weight"][0, 0, 0, 0] = 1.0
    sd["output_projection.weight"][0, 0, 0, 0] = 1.0
    ckpt = tmp_path / "v2.ckpt"
    torch.save({"state_dict": sd, "hyper_parameters": {
        "residual_channels": 1, "residual_layers": 1, "timesteps": STEPS}}, ckpt)
    model, _ = load_lightning(str(ckpt), "DiffRollv2", overrides={"frames": str(T)})
    x = np.zeros((1, T, 88), np.float32)
    x[0, 5, 40] = 1.0  # frame 5, key 40
    with torch.no_grad():
        out = model.apply(torch.from_numpy(x), torch.zeros(1, dtype=torch.long),
                          torch.zeros(1, T, 229)).numpy()[0]
    # g = sigmoid(0) * tanh(conv): nonzero where the tap reads the impulse
    assert np.unravel_index(np.abs(out - out[0, 0]).argmax(), out.shape) == (4, 41)
    jm = jmodels.build("DiffRollv2", **cfg)
    jout = np.asarray(jm.apply({"params": convert_state_dict(sd)}, jnp.asarray(x),
                               jnp.zeros((1,), jnp.int32), jnp.zeros((1, T, 229))))[0]
    assert np.unravel_index(np.abs(jout - jout[0, 0]).argmax(), jout.shape) == (6, 39)


# ------------------------------------------------------------ the train entry

@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return _write_tree(tmp_path_factory.mktemp("maps"), clips=4)


@pytest.mark.parametrize("argv", [
    ["model_name=DiffRollv2", "model.residual_channels=4", "model.residual_layers=2"],
    ["model.condition=trainable_spec", "model.spec_dropout=0.5"],
], ids=["v2", "trainable_spec"])
def test_train_entry(tree, tmp_path, argv):
    """Train two steps, validate (the val_hook's figures), checkpoint; the
    checkpoint reloads as the same variant with the same weights."""
    state = train_cli.main(["spec_roll", f"dataset.root={tree}", f"trainer.output_dir={tmp_path}",
                            "trainer.max_epochs=1", "task.fused_train=true", *TINY, *argv])
    (run_dir,) = tmp_path.glob("*/*/train-*")
    records = [json.loads(x) for x in (run_dir / "metrics.jsonl").read_text().splitlines()]
    assert state.step == 2 and any("val/diffusion_loss" in r for r in records)
    figures = sorted(p.name.rsplit("_", 1)[0] for p in (run_dir / "figures").glob("*.png"))
    want = ["val_rolls"] + (["val_trainable_params"] if "trainable" in argv[0] else [])
    assert figures == want
    model, _ = load_lightning(str(run_dir / "checkpoints" / "last.ckpt"))
    assert model.config == state.model.config
    for k, v in state.model.net.state_dict().items():
        assert torch.equal(model.net.state_dict()[k], v.cpu()), k


def test_param_heatmaps_match_jax():
    """The port's heatmaps of the learned substitutes are the JAX figure:
    the same panels, titles and pixels."""
    for key in ("trainable_spec", "trainable_z"):
        _, params, tm = _pair(key)
        tfig, jfig = param_heatmaps(tm.net), j_param_heatmaps(params)
        images = []
        for fig in (tfig, jfig):
            fig.canvas.draw()
            images.append(np.asarray(fig.canvas.buffer_rgba()))
        assert [a.get_title() for a in tfig.axes] == [a.get_title() for a in jfig.axes]
        np.testing.assert_array_equal(images[0], images[1])
    assert param_heatmaps(tmodels.build("DiffRoll", residual_channels=C,
                                        residual_layers=L).net) is None
