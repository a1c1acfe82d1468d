"""Figures: roll grids and the denoising animation (matplotlib, imported lazily)."""

from .figures import animate_trajectory, roll_figure, save_trajectory_gif

__all__ = ["roll_figure", "animate_trajectory", "save_trajectory_gif"]
