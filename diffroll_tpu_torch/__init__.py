"""diffroll_tpu_torch — the PyTorch/CUDA port of `diffroll_tpu`.

The JAX package beside it is the reference; this package mirrors its
module paths and names (`diffroll_tpu.tasks.diffusion` ->
`diffroll_tpu_torch.tasks.diffusion`, ...) so each counterpart is easy to
find. It imports `torch`, never `jax`, and nothing of `diffroll_tpu`: it
keeps its own copies of the host-side helpers (`io`, `eval.notes`, `native`,
`data`).

Conventions:
  * modules keep the reference checkpoint's PyTorch parameter names and
    layouts, so a Lightning `state_dict` loads with `load_state_dict`;
  * public functions keep the JAX package's channels-last layouts
    ((B, T, C) activations, (B, T, 88) rolls, (B, T, n_mels) spectrograms);
  * every random draw takes an explicit `torch.Generator` (or the noise
    itself), every entry point an explicit `device`;
  * the four TPU kernels of the reference (the gated residual stack, the
    whole-process sampler, and the stack's training forward and backward)
    are hand-written CUDA for sm_90a under `csrc/`, built with nvcc at first
    use (`ops/_build.py`). On CPU tensors their wrappers run the plain
    PyTorch versions that sit beside them.
"""

__version__ = "0.1.0"
