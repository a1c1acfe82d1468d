"""Figures: roll grids, heatmaps of the learned conditioning and the
denoising animation (matplotlib, imported lazily)."""

from .figures import animate_trajectory, param_heatmaps, roll_figure, save_trajectory_gif

__all__ = ["roll_figure", "param_heatmaps", "animate_trajectory", "save_trajectory_gif"]
