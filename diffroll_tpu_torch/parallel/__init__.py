"""The (data, model) mesh and sequence parallelism (counterpart of
`diffroll_tpu/parallel/`)."""

from .mesh import Mesh, setup_mesh
from .model_axis import full_state_dict, full_view, is_sharded, shard_module
from .context import sample_sequence_parallel, sequence_parallel_forward

__all__ = ["Mesh", "full_state_dict", "full_view", "is_sharded", "sample_sequence_parallel",
           "sequence_parallel_forward", "setup_mesh", "shard_module"]
