"""The data-parallel axis (counterpart of `diffroll_tpu/parallel/`)."""

from .mesh import DataMesh, setup_mesh

__all__ = ["DataMesh", "setup_mesh"]
