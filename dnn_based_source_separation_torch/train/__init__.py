"""Training and evaluation: optimizer, train/eval steps, the epoch-loop Trainer, the Tester."""

from .steps import (
    OptaxRMSprop, Optimizer, WarmupOptimizer, get_learning_rate, make_attractor_train_step,
    make_eval_step, make_optimizer, make_train_step, make_warmup_optimizer, set_learning_rate,
)
from .tester import AttractorTester, Evaluater, Tester, framewise_sdr
from .trainer import ORPITTrainer, Trainer, TrainerConfig

__all__ = ["AttractorTester", "Evaluater", "ORPITTrainer", "OptaxRMSprop", "Optimizer", "Tester",
           "framewise_sdr", "Trainer", "TrainerConfig", "WarmupOptimizer", "get_learning_rate",
           "make_attractor_train_step", "make_eval_step", "make_optimizer", "make_train_step",
           "make_warmup_optimizer", "set_learning_rate"]
