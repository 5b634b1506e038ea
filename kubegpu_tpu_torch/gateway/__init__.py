"""The port's copy of the JAX package's ``gateway/__init__.py``.

L5 serving gateway: the cluster-level inference front door.

Bridges the two halves of the serving stack: the control plane places
decode replicas on cards (scheduler/grpalloc/crishim) and the data plane
decodes inside one replica (models/paging.py); the gateway routes
cluster traffic TO those replicas — discovery from the same annotations
the scheduler writes, bounded fair admission, load-aware routing, and
deadline/retry/hedge failover.  Same architecture split as the
scheduler: pure core + thin HTTP codec, every cluster dependency behind
``ApiServer``, every data-plane dependency behind ``ReplicaClient`` —
the whole subsystem runs in-memory under test.  Only the replica side
(``ReplicaServer`` over the port's batchers) touches tensors; the
gateway side imports no torch.
"""

from kubegpu_tpu_torch.gateway.client import (
    Attempt,
    AttemptResult,
    InMemoryReplicaClient,
    ReplicaClient,
    SimBatcher,
    sim_stream_seed,
)
from kubegpu_tpu_torch.gateway.core import (
    Gateway,
    GatewayRequest,
    GatewayResult,
    PendingRequest,
    StreamRelay,
)
from kubegpu_tpu_torch.gateway.hashring import ConsistentHashRing
from kubegpu_tpu_torch.gateway.dataplane import (
    HttpReplicaClient,
    ReplicaServer,
    ReplicaServingLoop,
)
from kubegpu_tpu_torch.gateway.failover import (
    Dispatcher,
    FailoverPolicy,
    SessionKVStore,
)
from kubegpu_tpu_torch.gateway.prefixtier import PrefixTier, prompt_chain_keys
from kubegpu_tpu_torch.gateway.queue import AdmissionQueue, QueueClosed, QueueFull
from kubegpu_tpu_torch.gateway.registry import ReplicaInfo, ReplicaRegistry
from kubegpu_tpu_torch.gateway.router import (
    ConsistentHashRouter,
    LeastOutstandingRouter,
    PrefixLocalityRouter,
    Router,
    SessionAffinityRouter,
)
from kubegpu_tpu_torch.gateway.server import GatewayServer
from kubegpu_tpu_torch.gateway.sessionstore import (
    CircuitBreaker,
    HttpStoreClient,
    InProcessStoreBackend,
    SessionStoreBackend,
    StoreResult,
    StoreServer,
)
from kubegpu_tpu_torch.gateway.tier import GatewayTier, is_gateway_death

__all__ = [
    "AdmissionQueue",
    "Attempt",
    "AttemptResult",
    "CircuitBreaker",
    "ConsistentHashRing",
    "ConsistentHashRouter",
    "Dispatcher",
    "HttpStoreClient",
    "InProcessStoreBackend",
    "SessionStoreBackend",
    "StoreResult",
    "StoreServer",
    "FailoverPolicy",
    "Gateway",
    "GatewayRequest",
    "GatewayResult",
    "GatewayServer",
    "GatewayTier",
    "HttpReplicaClient",
    "InMemoryReplicaClient",
    "LeastOutstandingRouter",
    "ReplicaServer",
    "ReplicaServingLoop",
    "PendingRequest",
    "PrefixLocalityRouter",
    "PrefixTier",
    "prompt_chain_keys",
    "QueueClosed",
    "QueueFull",
    "ReplicaClient",
    "ReplicaInfo",
    "ReplicaRegistry",
    "Router",
    "SessionAffinityRouter",
    "SessionKVStore",
    "SimBatcher",
    "StreamRelay",
    "is_gateway_death",
    "sim_stream_seed",
]
