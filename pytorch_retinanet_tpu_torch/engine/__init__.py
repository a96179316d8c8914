"""Training engine of the port: optimizers and schedulers, the task model, the Trainer."""

from .model import RetinaNetModel
from .optim import (
    OPTIMIZER_REGISTRY,
    SCHEDULER_REGISTRY,
    LRScheduler,
    build_optimizer,
    build_scheduler,
    current_learning_rate,
    set_learning_rate,
    set_momentum,
    warmup_scale,
    wrap_accumulation,
)
from .trainer import Trainer

__all__ = [
    "LRScheduler",
    "OPTIMIZER_REGISTRY",
    "RetinaNetModel",
    "SCHEDULER_REGISTRY",
    "Trainer",
    "build_optimizer",
    "build_scheduler",
    "current_learning_rate",
    "set_learning_rate",
    "set_momentum",
    "warmup_scale",
    "wrap_accumulation",
]
