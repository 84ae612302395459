"""Training and evaluation: optimizer, train/eval steps, the epoch-loop Trainer, the Tester."""

from .steps import (
    Optimizer, get_learning_rate, make_eval_step, make_optimizer, make_train_step,
    set_learning_rate,
)
from .tester import Evaluater, Tester, framewise_sdr
from .trainer import Trainer, TrainerConfig

__all__ = ["Evaluater", "Optimizer", "Tester", "framewise_sdr", "Trainer", "TrainerConfig", "get_learning_rate", "make_eval_step",
           "make_optimizer", "make_train_step", "set_learning_rate"]
