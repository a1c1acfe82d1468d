"""The whole-process sampler (K2) and the sampling task, against the JAX
package on the same weights, x_T and per-step noise (the JAX draws
`jax.random.split` + `normal`, handed to the port as a tensor):

  * the port's plain `fused_sample_ref` vs the Pallas megakernel in
    interpret mode (bf16): max|d| / max|ref| < 0.05, the gate of
    tests/test_sampler_kernel.py;
  * the port's `DiffusionTask.sample` (plain, float32) vs the JAX scan path
    (`use_megakernel=False`, float32): rel < 1e-3, for both port routes.
The CUDA kernels against the plain versions are in
tests/test_torch_kernels_gpu.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffroll_tpu import models as jmodels
from diffroll_tpu.diffusion.loop import timestep_subsequence as j_subseq
from diffroll_tpu.ops import stack_weights as j_stack_weights
from diffroll_tpu.ops.fused_forward import _embed as j_embed
from diffroll_tpu.ops.sampler_kernel import fused_sample_pallas, head_weights as j_head
from diffroll_tpu.ops.sampler_kernel import sampler_tables as j_tables
from diffroll_tpu.tasks import DiffusionTask as JTask
from diffroll_tpu.tasks import TaskConfig as JTaskConfig
from diffroll_tpu_torch import models as tmodels
from diffroll_tpu_torch.compat import state_dict_from_jax
from diffroll_tpu_torch.ops.fused_forward import head_weights
from diffroll_tpu_torch.ops.gated_stack import stack_weights
from diffroll_tpu_torch.ops.sampler_kernel import fused_sample, fused_sample_ref
from diffroll_tpu_torch.tasks import DiffusionTask as TTask
from diffroll_tpu_torch.tasks import TaskConfig as TTaskConfig

torch.set_num_threads(1)
BF16_GATE = 0.05
F32_GATE = 1e-3
C, L, T, B, STEPS = 16, 4, 32, 2, 12


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-6))


@pytest.fixture(scope="module")
def pair():
    kw = dict(residual_channels=C, residual_layers=L, frames=T, timesteps=STEPS)
    jm = jmodels.build("ClassifierFreeDiffRoll", **kw)
    params = jm.init(jax.random.key(0))
    head = params["params"]["output_projection"]
    head["kernel"] = 0.1 * jax.random.normal(jax.random.key(9), head["kernel"].shape)
    tm = tmodels.build("ClassifierFreeDiffRoll", **kw)
    tm.net.load_state_dict(state_dict_from_jax(params))
    return jm, params, tm.eval()


def _jax_noise(key, n, shape):
    keys = jax.random.split(key, n)
    return np.asarray(jax.vmap(lambda k: jax.random.normal(k, shape))(keys))


def _jax_sched():
    from diffroll_tpu.diffusion.schedule import linear_schedule

    return linear_schedule(1e-4, 0.02, STEPS)


KERNEL_CASES = [("cfdg_ddpm_x0", None, 0.5), ("ddpm_x0", None, 0.0),
                ("cfdg_ddim_x0", 5, 0.5), ("ddpm", None, 0.0)]


@pytest.mark.parametrize("name,steps,w", KERNEL_CASES,
                         ids=["guided", "unguided", "deterministic", "epsilon"])
def test_plain_matches_pallas_interpret(pair, name, steps, w):
    jm, params, tm = pair
    rng = np.random.default_rng(1)
    ts = j_subseq(STEPS, steps)
    tsp = np.concatenate([ts[1:], [-1]]).astype(np.int32)
    tables = j_tables(_jax_sched(), name, ts, tsp)
    stochastic = bool(np.any(tables[:, 2] != 0))
    x_T = rng.standard_normal((B, T, 88)).astype(np.float32)
    noise = rng.standard_normal((len(ts), B, T, 88)).astype(np.float32)
    cond = rng.random((B, T, 229)).astype(np.float32)
    jw = j_stack_weights(params, L)
    t_emb = j_embed(jnp.asarray(ts), params["params"]["diffusion_embedding"], STEPS)
    t_bias = np.asarray(jnp.einsum("ne,lec->nlc", t_emb, jw.wt) + jw.bt[None])
    guided = name.startswith("cfdg")
    dil = jm.config.dilations()
    j = fused_sample_pallas(
        jnp.asarray(x_T), jnp.asarray(noise if stochastic else noise[:1]),
        jnp.asarray(t_bias), jnp.asarray(tables), jw, j_head(params), jnp.asarray(cond),
        dil, guided=guided, w_guidance=w, stochastic=stochastic, interpret=True)
    with torch.no_grad():
        t = fused_sample_ref(
            torch.from_numpy(x_T), torch.from_numpy(noise) if stochastic else None,
            torch.from_numpy(t_bias), torch.from_numpy(tables), stack_weights(tm.net),
            head_weights(tm.net), torch.from_numpy(cond), dil, guided, w, stochastic)
        # on CPU tensors the wrapper is the plain version, launch count untouched
        before = fused_sample.launches
        t2 = fused_sample(
            torch.from_numpy(x_T), torch.from_numpy(noise) if stochastic else None,
            torch.from_numpy(t_bias), torch.from_numpy(tables), stack_weights(tm.net),
            head_weights(tm.net), torch.from_numpy(cond), dil, guided, w, stochastic)
    assert torch.equal(t, t2) and fused_sample.launches == before
    assert _rel(t.numpy(), j) < BF16_GATE, name


TASK_CASES = [
    ("cfdg_ddpm_x0", None, {}),
    ("cfdg_ddim_x0", 5, {}),
    ("ddpm_x0", None, {}),
    ("generation_ddpm_x0", None, {}),
    ("inpainting_ddpm_x0", None, {"inpainting_t": (4, 12)}),
    ("ddpm", None, {}),
    ("ddim", 4, {}),
    ("ddim2ddpm", None, {}),
]


_JAX_SCAN = {}


@pytest.mark.parametrize("route", ["scan", "megakernel", "module"])
@pytest.mark.parametrize("name,steps,extra", TASK_CASES,
                         ids=[c[0] + str(c[1] or "") for c in TASK_CASES])
def test_task_sample_matches_jax_scan(pair, name, steps, extra, route):
    """The slice at task level: waveform -> mel conditioner -> the whole
    reverse process. Port routes on CPU: the step loop with the fused
    forward, the whole-process route (plain), the module forward."""
    jm, params, tm = pair
    rng = np.random.default_rng(2)
    wav = (0.1 * rng.standard_normal((B, T * 512))).astype(np.float32)
    x_T = rng.standard_normal((B, T, 88)).astype(np.float32)
    key = jax.random.key(3)
    if name not in _JAX_SCAN:  # one JAX run per sampler, shared by the routes
        jcfg = JTaskConfig(timesteps=STEPS, sampling_type=name, w=0.5,
                           sampling_steps=steps, use_megakernel=False, **extra)
        _JAX_SCAN[name] = np.asarray(JTask(jm, jcfg).sample(
            params, jnp.asarray(x_T), key, waveform=jnp.asarray(wav))[0])
    j = _JAX_SCAN[name]
    n = len(j_subseq(STEPS, steps))
    noise = torch.from_numpy(_jax_noise(key, n, x_T.shape))
    tcfg = TTaskConfig(timesteps=STEPS, sampling_type=name, w=0.5, sampling_steps=steps,
                       use_megakernel=route == "megakernel",
                       use_fused=False if route == "module" else None, **extra)
    t, traj = TTask(tm, tcfg).sample(torch.from_numpy(x_T), waveform=torch.from_numpy(wav),
                                     noise=noise)
    assert traj is None and t.shape == (B, T, 88)
    assert _rel(t.numpy(), j) < F32_GATE, (name, route, _rel(t.numpy(), j))


def test_trajectory_matches_jax(pair):
    jm, params, tm = pair
    rng = np.random.default_rng(4)
    wav = (0.1 * rng.standard_normal((B, T * 512))).astype(np.float32)
    x_T = rng.standard_normal((B, T, 88)).astype(np.float32)
    key = jax.random.key(5)
    cfg = dict(timesteps=STEPS, sampling_type="cfdg_ddpm_x0", w=0.5)
    j0, jtraj = JTask(jm, JTaskConfig(**cfg)).sample(
        params, jnp.asarray(x_T), key, waveform=jnp.asarray(wav), record_every=5)
    noise = torch.from_numpy(_jax_noise(key, STEPS, x_T.shape))
    t0, ttraj = TTask(tm, TTaskConfig(**cfg)).sample(
        torch.from_numpy(x_T), waveform=torch.from_numpy(wav), noise=noise, record_every=5)
    assert ttraj.shape == np.asarray(jtraj).shape == (3, B, T, 88)
    assert _rel(ttraj.numpy(), jtraj) < F32_GATE and _rel(t0.numpy(), j0) < F32_GATE


def test_generator_draws_are_shared_by_both_routes(pair):
    """With only a generator, the step loop and the whole-process route
    consume the same draws and agree; a stochastic sampler without either
    raises."""
    jm, params, tm = pair
    x_T = torch.randn(1, T, 88, generator=torch.Generator().manual_seed(0))
    wav = torch.zeros(1, T * 512)
    outs = [TTask(tm, TTaskConfig(timesteps=STEPS, w=0.5, use_megakernel=mk)).sample(
        x_T, waveform=wav, generator=torch.Generator().manual_seed(1))[0] for mk in (False, True)]
    assert _rel(outs[0].numpy(), outs[1].numpy()) < F32_GATE
    with pytest.raises(ValueError, match="needs `noise`"):
        TTask(tm, TTaskConfig(timesteps=STEPS)).sample(x_T, waveform=wav)


@pytest.mark.parametrize("megakernel", [True, False], ids=["megakernel", "step_loop"])
def test_task_keeps_its_operands_until_training_moves_the_weights(megakernel):
    """The task prepares its sampling operands once and reuses them across
    `sample` calls; `loss_fn(train=True)` drops them, so after an optimizer
    step the next `sample` reads the new weights, as a fresh task does."""
    torch.manual_seed(0)
    tm = tmodels.build("ClassifierFreeDiffRoll", residual_channels=C, residual_layers=2,
                       frames=T, timesteps=STEPS)
    torch.nn.init.normal_(tm.net.output_projection.weight, std=0.1)
    cfg = TTaskConfig(timesteps=STEPS, w=0.5, use_megakernel=megakernel)
    task = TTask(tm, cfg)
    gen = torch.Generator().manual_seed(1)
    x_T, wav = torch.randn(B, T, 88, generator=gen), 0.1 * torch.randn(B, T * 512, generator=gen)
    noise = torch.randn(STEPS, B, T, 88, generator=gen)
    first = task.sample(x_T, waveform=wav, noise=noise)[0]
    kept = task.sampler_operands()
    assert torch.equal(task.sample(x_T, waveform=wav, noise=noise)[0], first)
    assert task.sampler_operands() is kept
    opt = torch.optim.Adam(tm.net.parameters(), lr=1e-2)
    batch = {"frame": (torch.rand(B, T, 88, generator=gen) > 0.9).float(), "audio": wav}
    task.loss_fn(batch, gen)[0].backward()
    opt.step()
    moved = task.sample(x_T, waveform=wav, noise=noise)[0]
    assert task.sampler_operands() is not kept
    assert torch.equal(moved, TTask(tm, cfg).sample(x_T, waveform=wav, noise=noise)[0])
    assert not torch.equal(moved, first)
