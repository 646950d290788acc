"""Training substrate of the port: optimizers, schedules, and the
factories of the train and eval steps."""

from .optimizer import (Optimizer, TrainConfig, apply_updates,
                        clip_by_global_norm, global_norm, lr_schedule,
                        make_adafactor, make_adamw, make_optimizer, make_sgd)
from .train_step import init_state, make_eval_step, make_train_step, state_of

__all__ = [
    "TrainConfig", "Optimizer", "make_optimizer", "make_adamw",
    "make_adafactor", "make_sgd", "apply_updates", "lr_schedule",
    "global_norm", "clip_by_global_norm",
    "init_state", "state_of", "make_train_step", "make_eval_step",
]
