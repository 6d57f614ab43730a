"""bigdl_tpu_torch.serving — the in-process inference server, the paged
KV pool and the prefill/decode handoff."""
from .kvpool import KVPagePool, PageLease, PoolExhausted
from .pools import HandoffCorrupt
from .server import InferenceServer
from .status import ServeFuture, ServeResult, Status
