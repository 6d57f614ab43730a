"""bigdl_tpu_torch.serving — the in-process inference server, the paged
KV pool, the prefill/decode handoff and the verified hot swap."""
from .kvpool import KVPagePool, PageLease, PoolExhausted
from .pools import HandoffCorrupt
from .server import InferenceServer
from .status import ServeFuture, ServeResult, Status
from .swap import DeployInFlight, SwapRejected, load_verified_params
