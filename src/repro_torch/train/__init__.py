from .train_step import (batch_logical_axes, loss_fn, make_batch_shapes,
                         make_prefill_step, make_serve_step, make_train_step)
from .trainer import SimulatedFailure, Trainer, TrainerConfig
