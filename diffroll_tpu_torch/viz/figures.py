"""Roll figures, heatmaps of the learned conditioning and denoising GIFs on
numpy (counterpart of `diffroll_tpu/viz/figures.py`: `roll_figure`,
`param_heatmaps`, `animate_trajectory`, `save_trajectory_gif`).

Equivalent of the reference's figure grids (`visualize_figure`, reference
task/diffusion.py:643-649, 1069-1076) and its reverse-process animation
(`animate_sampling`, :1078-1088, GIF export :356-378). matplotlib is imported
inside the functions, so the module imports without it.
"""

from __future__ import annotations

import pathlib
from typing import Optional

import numpy as np


def _mpl():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def roll_figure(
    pred: np.ndarray,
    label: Optional[np.ndarray] = None,
    spec: Optional[np.ndarray] = None,
    max_cols: int = 2,
):
    """Grid of predicted rolls (top), labels / specs below when given.

    pred/label: (B, T, 88); spec: (B, T, n_mels). Returns the figure.
    """
    plt = _mpl()
    pred = np.asarray(pred)
    b = min(pred.shape[0], max_cols)
    rows = 1 + (label is not None) + (spec is not None)
    fig, axes = plt.subplots(rows, b, figsize=(4 * b, 2.2 * rows),
                             squeeze=False)
    for j in range(b):
        axes[0][j].imshow(pred[j].T, aspect="auto", origin="lower",
                          cmap="magma")
        axes[0][j].set_title(f"pred {j}", fontsize=8)
        r = 1
        if label is not None:
            axes[r][j].imshow(np.asarray(label)[j].T, aspect="auto",
                              origin="lower", cmap="magma")
            axes[r][j].set_title(f"label {j}", fontsize=8)
            r += 1
        if spec is not None:
            axes[r][j].imshow(np.asarray(spec)[j].T, aspect="auto",
                              origin="lower", cmap="viridis")
            axes[r][j].set_title(f"spec {j}", fontsize=8)
    for ax in fig.axes:
        ax.set_xticks([])
        ax.set_yticks([])
    fig.tight_layout()
    return fig


def param_heatmaps(net, names=("trainable_parameters", "uncon_z"), max_panels: int = 4):
    """Heatmaps of a net's learned unconditional embeddings (the reference
    logs them every validation epoch), or None when it has none. The port
    keeps them in the reference's (width, frames) layout, the transpose of
    the JAX package's, so each is drawn as stored; panels go in the order of
    the JAX package's sorted parameter tree, which sorting the dotted names
    reproduces."""
    leaves = [(name, p.detach().cpu().numpy()) for name, p in sorted(net.named_parameters())
              if any(n in name for n in names) and p.ndim == 2][:max_panels]
    if not leaves:
        return None
    plt = _mpl()
    fig, axes = plt.subplots(1, len(leaves), figsize=(4 * len(leaves), 2.5),
                             squeeze=False)
    for ax, (name, leaf) in zip(axes[0], leaves):
        im = ax.imshow(leaf, aspect="auto", origin="lower", cmap="coolwarm")
        ax.set_title(name.rsplit(".", 1)[-1], fontsize=7)
        fig.colorbar(im, ax=ax, fraction=0.05)
        ax.set_xticks([])
        ax.set_yticks([])
    fig.tight_layout()
    return fig


def animate_trajectory(trajectory: np.ndarray, clip: int = 0, fps: int = 8):
    """(S, B, T, 88) sampler trajectory -> matplotlib animation for `clip`."""
    plt = _mpl()
    from matplotlib.animation import FuncAnimation

    traj = np.asarray(trajectory)[:, clip]  # (S, T, 88)
    fig, ax = plt.subplots(figsize=(6, 3))
    im = ax.imshow(traj[0].T, aspect="auto", origin="lower", cmap="magma",
                   vmin=traj.min(), vmax=traj.max())
    ax.set_xticks([])
    ax.set_yticks([])
    title = ax.set_title("step 0", fontsize=9)

    def update(i):
        im.set_data(traj[i].T)
        title.set_text(f"step {i}")
        return [im, title]

    anim = FuncAnimation(fig, update, frames=len(traj), interval=1000 // fps,
                         blit=False)
    return fig, anim


def save_trajectory_gif(
    trajectory: np.ndarray,
    path: str | pathlib.Path,
    clip: int = 0,
    fps: int = 8,
) -> pathlib.Path:
    """Write the denoising animation as a GIF (pillow writer — the
    reference needs imagemagick, reference task/diffusion.py:377)."""
    fig, anim = animate_trajectory(trajectory, clip=clip, fps=fps)
    path = pathlib.Path(path)
    anim.save(str(path), writer="pillow", fps=fps)
    _mpl().close(fig)
    return path
