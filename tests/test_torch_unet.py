"""The port's U-Nets (`Unet`, `SpecUnet`) against the JAX package on the CPU,
on the same weights (through `state_dict_from_jax`), inputs and draws:

  * the forward (SpecUnet: both classifier-free branches, a mixed
    `uncond_mask`), and the ResNet-block variant (`use_convnext=false`):
    atol 1e-4, rtol 1e-3;
  * the task's loss (1e-5) and every parameter gradient (max|d| / max|ref| <
    2e-3), the JAX `loss_fn`'s draws handed to the port: the `pianoroll`
    recipe (epsilon, huber) for the Unet, `spec_roll` for SpecUnet;
  * a 10-step trajectory against the JAX scan path (`ddpm` unconditional;
    `cfdg_ddpm_x0` guided), x_T and the per-step noise passed in: rel < 1e-3;
  * the 2x upsampler and the stride-2 downsampler alone, on random
    (asymmetric) kernels, at even and odd sizes;
  * `train pianoroll` -> `infer`, and `train spec_roll model_name=SpecUnet`
    with the post-fit test.

Size: dim 6 (the published 28 cut), dim_mults (1, 2, 4), 16 frames, 10 steps.
"""

import functools
import json

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffroll_tpu import models as jmodels
from diffroll_tpu.nn import unet as junet
from diffroll_tpu.tasks import DiffusionTask as JTask
from diffroll_tpu.tasks import TaskConfig as JTaskConfig
from diffroll_tpu_torch import models as tmodels
from diffroll_tpu_torch.cli import infer as infer_cli
from diffroll_tpu_torch.cli import train as train_cli
from diffroll_tpu_torch.compat import state_dict_from_jax
from diffroll_tpu_torch.io.midi import read_midi
from diffroll_tpu_torch.nn.unet import Downsample, upsample
from diffroll_tpu_torch.tasks import DiffusionTask as TTask
from diffroll_tpu_torch.tasks import TaskConfig as TTaskConfig
from test_torch_test_cli import _write_split  # the synthetic MAPS splits
from test_torch_variants import compare_loss_and_grads, jax_params, jax_noise, rel

torch.set_num_threads(1)
ATOL, RTOL, F32_GATE = 1e-4, 1e-3, 1e-3
T, B, STEPS = 16, 4, 10
KW = dict(residual_channels=6, frames=T, timesteps=STEPS)


@functools.lru_cache(maxsize=None)
def _pair(name, **extra):
    kw = {**KW, **extra}
    jm = jmodels.build(name, **kw)
    params = jax_params(jm)
    tm = tmodels.build(name, **kw)
    tm.net.load_state_dict(state_dict_from_jax(params))
    return jm, params, tm


def _inputs(seed, b=B):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, T, 88)).astype(np.float32),
            rng.integers(0, STEPS, size=b).astype(np.int32),
            rng.random((b, T, 229)).astype(np.float32))


@pytest.mark.parametrize("extra", [{}, {"use_convnext": False, "residual_channels": 8}],
                         ids=["convnext", "resnet"])
def test_unet_forward_matches(extra):
    jm, params, tm = _pair("Unet", **extra)
    x, t, _ = _inputs(1)
    j = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x), jnp.asarray(t), None))
    tm.eval()
    with torch.no_grad():
        out = tm.apply(torch.from_numpy(x), torch.from_numpy(t), None).numpy()
    assert out.shape == (B, T, 88) and np.abs(j).max() > 0.1
    np.testing.assert_allclose(out, j, atol=ATOL, rtol=RTOL)


def test_spec_unet_forward_and_cfg_match():
    """Both guidance branches in one 2B forward: rows [0, B) conditional, rows
    [B, 2B) with the log-mel := -1; and the port's forward on those rows
    with the mixed mask given explicitly."""
    jm, params, tm = _pair("SpecUnet")
    x, t, cond = _inputs(2)
    jc, ju = jax.jit(jm.apply_cfg)(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(cond))
    tx, tt, tc = torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(cond)
    tm.eval()
    with torch.no_grad():
        pc, pu = tm.apply_cfg(tx, tt, tc)
        mask = torch.arange(2 * B) >= B
        mixed = tm.apply(torch.cat([tx, tx]), torch.cat([tt, tt]), torch.cat([tc, tc]), mask)
    assert not np.allclose(np.asarray(jc), np.asarray(ju), atol=1e-3)
    for a, b in [(pc, jc), (pu, ju), (mixed[:B], jc), (mixed[B:], ju)]:
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("name,task", [
    ("Unet", dict(training_mode="epsilon", loss_type="huber")),
    ("SpecUnet", dict(training_mode="x_0", loss_type="l2")),
])
def test_loss_and_grads_match(name, task):
    jm, params, tm = _pair(name)
    rng = np.random.default_rng(3)
    batch = {"frame": (rng.random((B, T, 88)) > 0.8).astype(np.float32),
             "audio": (0.1 * rng.standard_normal((B, T * 512))).astype(np.float32)}
    _, got = compare_loss_and_grads(jm, params, tm, dict(timesteps=STEPS, **task),
                                    jax.random.key(4), batch)
    if name == "SpecUnet":
        # the last block's spectrogram branch feeds nothing: no gradient
        assert got["final_block.spec_net_conv2.weight"] is None


@pytest.mark.parametrize("name,sampler", [("Unet", "ddpm"), ("SpecUnet", "cfdg_ddpm_x0")])
def test_trajectory_matches_jax_scan(name, sampler):
    jm, params, tm = _pair(name)
    rng = np.random.default_rng(5)
    x_T = rng.standard_normal((2, T, 88)).astype(np.float32)
    wav = (0.1 * rng.standard_normal((2, T * 512))).astype(np.float32)
    key = jax.random.key(6)
    cfg = dict(timesteps=STEPS, sampling_type=sampler, w=0.5)
    j0, jtraj = JTask(jm, JTaskConfig(use_megakernel=False, **cfg)).sample(
        params, jnp.asarray(x_T), key, waveform=jnp.asarray(wav), record_every=5)
    tm.eval()
    t0, ttraj = TTask(tm, TTaskConfig(**cfg)).sample(
        torch.from_numpy(x_T), waveform=torch.from_numpy(wav),
        noise=torch.from_numpy(jax_noise(key, STEPS, x_T.shape)), record_every=5)
    assert ttraj.shape == np.asarray(jtraj).shape == (2, 2, T, 88)
    assert rel(ttraj.numpy(), jtraj) < F32_GATE and rel(t0.numpy(), j0) < F32_GATE


class _Resample(fnn.Module):
    up: bool

    @fnn.compact
    def __call__(self, x):
        return (junet._upsample if self.up else junet._downsample)(x, x.shape[-1], "r")


def _resampler_pair(up, channels, seed):
    """flax's resampler with random kernel and bias, and the port's holding
    them through `state_dict_from_jax` (a U-Net tree: `init_conv` marks it)."""
    rng = np.random.default_rng(seed)
    params = {"r": {"kernel": rng.standard_normal((4, 4, channels, channels)).astype(np.float32),
                    "bias": rng.standard_normal(channels).astype(np.float32)}}
    scope = "up_0_us" if up else "down_0_ds"
    sd = state_dict_from_jax({"init_conv": {"bias": np.zeros(1, np.float32)},
                              scope: params["r"]})
    port = upsample(channels) if up else Downsample(channels)
    port.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items() if k.startswith(scope)})
    return _Resample(up), {"params": params}, port


@pytest.mark.parametrize("up", [True, False], ids=["upsample", "downsample"])
@pytest.mark.parametrize("hw", [(6, 4), (5, 11)])
def test_resamplers_match_flax(up, hw):
    """The port's resampler and flax's on the same random kernels: the
    upsampler is ConvTranspose2d(4, 2, 1) on the spatially flipped kernel,
    exactly 2x; the downsampler pads 'SAME' (ceil(n / 2) positions)."""
    mod, params, port = _resampler_pair(up, 3, seed=hw[0])
    x = np.random.default_rng(7).standard_normal((2, *hw, 3)).astype(np.float32)
    j = np.asarray(mod.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        out = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    want = tuple(2 * n for n in hw) if up else tuple(-(-n // 2) for n in hw)
    assert out.shape[1:3] == j.shape[1:3] == want
    np.testing.assert_allclose(out, j, atol=ATOL, rtol=RTOL)
    if up:  # the kernel as it is would be wrong: the flip matters
        port.weight.data = torch.from_numpy(
            params["params"]["r"]["kernel"].transpose(2, 3, 0, 1).copy())
        with torch.no_grad():
            unflipped = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        assert np.abs(unflipped.numpy() - j).max() > 0.1


# ------------------------------------------------------------ the entries

SMALL = ["model.residual_channels=6", f"model.frames={T}", f"dataset.sequence_length={T * 512}",
         "task.timesteps=4", "dataloader.train_batch_size=2", "dataloader.val_batch_size=2",
         "dataloader.test_batch_size=2", "dataloader.num_workers=1", "trainer.max_epochs=1",
         "trainer.check_val_every_n_epoch=1", "device=cpu", "dataset.name=MAPS", "audio_format=wav"]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("maps")
    _write_split(root, "AkPnBcht", 4, 1.0, seed=0)
    _write_split(root, "ENSTDkCl", 2, 1.0, seed=1)
    return root


def test_train_pianoroll_then_infer(tree, tmp_path):
    out = tmp_path / "out"
    state = train_cli.main(["pianoroll", f"dataset.root={tree}", f"trainer.output_dir={out}",
                            *SMALL])
    assert state.model.config.variant == "unet" and state.step == 2
    (ckpt,) = out.glob("*/*/train-*/checkpoints/last.ckpt")
    run_dir = infer_cli.main([f"pretrained_path={ckpt}", "num_samples=2", "device=cpu",
                              f"trainer.output_dir={out}"])
    manifest = json.loads((run_dir / "manifest.json").read_text())
    assert [m["clip"] for m in manifest] == ["roll_000", "roll_001"]
    for m in manifest:
        z = np.load(run_dir / f"{m['clip']}.npz")
        # 4 steps, every 10th recorded: the final state alone
        assert z["roll"].shape == (T, 88) and z["trajectory"].shape == (1, T, 88)
        np.testing.assert_array_equal(z["trajectory"][-1], z["roll"])
        assert len(read_midi(str(run_dir / f"{m['clip']}.mid"))) == m["notes"]


def test_train_spec_unet_with_the_post_fit_test(tree, tmp_path):
    state = train_cli.main(["spec_roll", "model_name=SpecUnet", f"dataset.root={tree}",
                            f"trainer.output_dir={tmp_path}", *SMALL])
    assert state.model.config.variant == "spec_unet" and state.step == 2
    (run_dir,) = tmp_path.glob("*/*/train-*")
    metrics = json.loads((run_dir / "test_metrics.json").read_text())
    assert metrics["n_clips"] == 2 and 0.0 <= metrics["frame_f1"] <= 1.0
    assert (run_dir / "figures").is_dir()
