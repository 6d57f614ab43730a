"""bigdl_tpu_torch.serving — the in-process inference server."""
from .server import InferenceServer
from .status import ServeFuture, ServeResult, Status
