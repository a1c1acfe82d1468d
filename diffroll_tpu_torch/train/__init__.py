from .checkpoint import Checkpointer
from .loop import fit
from .state import TrainState, make_optimizer
from .step import make_eval_step, make_train_step

__all__ = [
    "Checkpointer",
    "TrainState",
    "fit",
    "make_eval_step",
    "make_optimizer",
    "make_train_step",
]
