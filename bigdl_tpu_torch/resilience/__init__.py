"""bigdl_tpu_torch.resilience — the gradient guard and loss-spike
detector, verified checkpoints (crc32c sidecars, quarantine, walk-back
restore), the background checkpoint writer, the retry policy, graceful
preemption and the fault injectors the recovery tests drive."""
from .async_checkpoint import AsyncCheckpointError, AsyncCheckpointWriter
from .checkpoint import (CorruptCheckpointError, quarantine, verified_load,
                         verify_and_load_latest, verify_file, write_sidecar)
from .guards import LossSpikeDetector, tree_finite, where_tree
from .preemption import PreemptionHandler, request_preemption
from .retry import (FatalTrainingError, LossSpikeError, RetryPolicy,
                    classify_error)
