"""bigdl_tpu_torch.optim — optim methods, triggers, validation methods,
the evaluator, the predictor and the local training loop."""
from .evaluator import Evaluator, LocalValidator, evaluate_dataset
from .metrics import Metrics
from .optim_method import SGD, Adam, Default, LearningRateSchedule, OptimMethod
from .optimizer import LocalOptimizer, Optimizer
from .predictor import LocalPredictor, Predictor
from .trigger import (Trigger, every_epoch, max_epoch, max_iteration,
                      max_score, min_loss, several_iteration)
from .validation import (MAE, AccuracyResult, Loss, LossResult,
                         Top1Accuracy, Top5Accuracy, TreeNNAccuracy,
                         ValidationMethod, ValidationResult)
