"""bigdl_tpu_torch.optim — optim methods, triggers and the local
training loop."""
from .optim_method import SGD, Adam, Default, LearningRateSchedule, OptimMethod
from .optimizer import LocalOptimizer, Optimizer
from .trigger import (Trigger, every_epoch, max_epoch, max_iteration,
                      max_score, min_loss, several_iteration)
