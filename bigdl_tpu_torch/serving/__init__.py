"""bigdl_tpu_torch.serving — the in-process inference server, the paged
KV pool, the prefill/decode handoff, the verified hot swap, and the
replica fleet over them: membership on the elastic KV transport
(:class:`ReplicaAgent`, :class:`ServingFleet`), the failover router with
retries and hedges (:class:`FleetRouter`), request tracing across
replicas, the model registry with per-tenant admission, per-replica SLO
health and the autoscaler.  Not ported yet: the JAX package's
``sparse_fetch`` (it needs the embedding store) and ``compile_cache``
(the port compiles no program)."""
from .autoscale import AutoscalePolicy, Autoscaler
from .batcher import MicroBatcher
from .breaker import CircuitBreaker
from .fleet import FleetQuorumError, ReplicaAgent, ServingFleet
from .health import FleetHealthMonitor, ReplicaHealthPolicy
from .kvpool import KVPagePool, PageLease, PoolExhausted
from .metrics import ServingMetrics
from .pools import HandoffCorrupt
from .request_trace import (ReplicaTraceSink, RequestTracer,
                            trace_attribution, trace_coverage)
from .router import FleetRouter
from .server import InferenceServer
from .status import ServeFuture, ServeResult, Status
from .swap import DeployInFlight, SwapRejected, load_verified_params

__all__ = [
    "AutoscalePolicy", "Autoscaler", "CircuitBreaker", "DeployInFlight",
    "FleetHealthMonitor", "FleetQuorumError", "FleetRouter",
    "HandoffCorrupt", "InferenceServer", "KVPagePool", "MicroBatcher",
    "PageLease", "PoolExhausted", "ReplicaAgent", "ReplicaHealthPolicy",
    "ReplicaTraceSink", "RequestTracer", "ServeFuture", "ServeResult",
    "ServingFleet", "ServingMetrics", "Status", "SwapRejected",
    "load_verified_params", "trace_attribution", "trace_coverage",
]
