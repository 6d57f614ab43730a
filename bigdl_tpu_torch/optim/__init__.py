"""bigdl_tpu_torch.optim — optim methods and schedules, regularizers, the
``torch.optim`` bridge, triggers, validation methods, the evaluator, the
predictor, and the local and data-parallel training loops (the JAX
package's exports)."""
from .optim_method import (
    SGD, Adadelta, Adagrad, Adam, Adamax, Default, EpochDecay, EpochSchedule,
    EpochStep, Exponential, LBFGS, LearningRateSchedule, MultiStep, NaturalExp,
    OptimMethod, Plateau, Poly, RMSprop, Step,
)
from .trigger import (
    Trigger, every_epoch, max_epoch, max_iteration, max_score, min_loss,
    several_iteration,
)
from .validation import (
    AccuracyResult, Loss, LossResult, MAE, Top1Accuracy, Top5Accuracy,
    TreeNNAccuracy, ValidationMethod, ValidationResult,
)
from .regularizer import (L1L2Regularizer, L1Regularizer, L2Regularizer,
                          Regularizer)
from .metrics import Metrics
from .optax_bridge import OptaxMethod, TorchOptimMethod
from .optimizer import LocalOptimizer, Optimizer
from .distri_optimizer import DistriOptimizer
from .evaluator import (DistriValidator, Evaluator, LocalValidator,
                        evaluate_dataset)
from .predictor import LocalPredictor, Predictor
