"""`train` from the JAX package's initial weight distributions.

The port draws its dense (Linear) kernels as the JAX package does (Flax's
LeCun-normal, `nn/init.py`) and its biases and conv kernels as the reference
does (PyTorch's defaults: every conv and linear bias uniform in
+-1/sqrt(fan_in), kaiming-normal conv kernels). The JAX package's biases
are zero, and its conv kernels he-normal truncated at two standard
deviations. This entry zeroes
every bias and draws every dense kernel again as Flax does, right after
`train` builds the model from `trainer.seed`, and then trains as `train`
does. It exists to tell what the JAX package's checkpoints learned from
their start apart from what they learned from their draws (ROADMAP Queue 3,
inpainting inside a band).

    python -m diffroll_tpu_torch.quality.flax_init spec_roll dataset.root=<tree> ... \
        [device=cuda|cpu]

Every argument is `train`'s.
"""

from __future__ import annotations

import math
import sys
from typing import List, Optional

import torch
from torch import nn

from ..cli import _common
from ..cli import train as train_cli


@torch.no_grad()
def flax_init_(net: nn.Module) -> None:
    """Zero every conv and linear bias; draw every linear weight from Flax's
    `lecun_normal` (a normal truncated at two standard deviations, scaled to
    variance 1/fan_in). Conv kernels keep their draw."""
    for module in net.modules():
        if isinstance(module, nn.Linear):
            std = 1.0 / math.sqrt(module.in_features) / 0.87962566103423978
            nn.init.trunc_normal_(module.weight, std=std, a=-2 * std, b=2 * std)
        if isinstance(module, (nn.Linear, nn.Conv1d, nn.Conv2d)) and module.bias is not None:
            nn.init.zeros_(module.bias)


def main(argv: Optional[List[str]] = None) -> train_cli.TrainState:
    setup = _common.setup_model_task

    def setup_flax(*args, **kwargs):
        model, task = setup(*args, **kwargs)
        flax_init_(model.net)
        return model, task

    _common.setup_model_task = setup_flax
    try:
        return train_cli.main(sys.argv[1:] if argv is None else argv)
    finally:
        _common.setup_model_task = setup


if __name__ == "__main__":
    main()
