from .torch_ckpt import (
    config_from_hparams,
    load_lightning,
    plain_hparams,
    state_dict_from_jax,
    task_updates_from_hparams,
)

__all__ = [
    "config_from_hparams",
    "load_lightning",
    "plain_hparams",
    "state_dict_from_jax",
    "task_updates_from_hparams",
]
