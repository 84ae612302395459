"""Training: optimizer, train/eval steps and the epoch-loop Trainer."""

from .steps import (
    Optimizer, get_learning_rate, make_eval_step, make_optimizer, make_train_step,
    set_learning_rate,
)
from .trainer import Trainer, TrainerConfig

__all__ = ["Optimizer", "Trainer", "TrainerConfig", "get_learning_rate", "make_eval_step",
           "make_optimizer", "make_train_step", "set_learning_rate"]
