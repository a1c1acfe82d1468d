from .torch_ckpt import (
    adam_state_from_optax,
    config_from_hparams,
    grads_from_jax,
    load_adam_state,
    load_lightning,
    plain_hparams,
    read_ckpt,
    state_dict_from_jax,
    task_config_from_hparams,
    task_updates_from_hparams,
)

__all__ = [
    "adam_state_from_optax",
    "config_from_hparams",
    "grads_from_jax",
    "load_adam_state",
    "load_lightning",
    "plain_hparams",
    "read_ckpt",
    "state_dict_from_jax",
    "task_config_from_hparams",
    "task_updates_from_hparams",
]
