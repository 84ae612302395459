"""Training and evaluation: optimizer, train/eval steps, the epoch-loop Trainer, the Tester."""

from .steps import (
    Optimizer, get_learning_rate, make_eval_step, make_optimizer, make_train_step,
    set_learning_rate,
)
from .tester import Tester
from .trainer import Trainer, TrainerConfig

__all__ = ["Optimizer", "Tester", "Trainer", "TrainerConfig", "get_learning_rate", "make_eval_step",
           "make_optimizer", "make_train_step", "set_learning_rate"]
