"""Continuous-batching serving over a paged KV pool, and the serving
fleet above it: replica (one engine behind a line-JSON socket) <- router
(health-aware front door with failover, drain and shedding), with the KV
handoff between prefill and decode replicas, the autoscaler, the weight
rollout and the chaos harness."""

from deepspeed_tpu_torch.inference.serving.config import (
    AutoscaleConfig,
    BreakerConfig,
    DegradeConfig,
    FleetConfig,
    HandoffConfig,
    RolesConfig,
    RolloutConfig,
    ServingConfig,
)
from deepspeed_tpu_torch.inference.serving.engine import ServingEngine
from deepspeed_tpu_torch.inference.serving.fault_injection import ServingFaultInjector
from deepspeed_tpu_torch.inference.serving.handoff import (
    HandoffError,
    HandoffFrameError,
    HandoffReceiver,
    HandoffRejectedError,
    HandoffRetryError,
    HandoffSender,
    HandoffSizeError,
    HandoffTimeoutError,
)
from deepspeed_tpu_torch.inference.serving.kv_pool import (
    KVCachePool,
    PageStateError,
    PoolExhaustedError,
)
from deepspeed_tpu_torch.inference.serving.metrics import RolloutMetrics, ServingMetrics
from deepspeed_tpu_torch.inference.serving.prefix_cache import (
    MemoryPressureGuard,
    PrefixKVCache,
    SpillStore,
    decode_spill_blob,
    encode_spill_blob,
    read_host_rss_mb,
)
from deepspeed_tpu_torch.inference.serving.replica import ReplicaServer
from deepspeed_tpu_torch.inference.serving.rollout import RolloutController
from deepspeed_tpu_torch.inference.serving.router import (
    REPLICA_ROLES,
    FleetOverloadError,
    ReplicaEndpoint,
    RequestPoisonedError,
    Router,
    WrongRoleError,
)
from deepspeed_tpu_torch.inference.serving.scheduler import (
    ContinuousBatchingScheduler,
    EngineDrainingError,
    QueueFullError,
    RequestTimeoutError,
    ServingFuture,
    bucket_for,
    default_buckets,
)

__all__ = [
    "ServingEngine", "ServingConfig", "ServingMetrics", "ServingFuture",
    "KVCachePool", "PoolExhaustedError", "PrefixKVCache",
    "ContinuousBatchingScheduler", "QueueFullError", "RequestTimeoutError",
    "EngineDrainingError", "ServingFaultInjector", "bucket_for",
    "default_buckets", "FleetConfig", "Router", "ReplicaEndpoint",
    "ReplicaServer", "FleetOverloadError", "RequestPoisonedError",
    "RolloutConfig", "RolloutController", "RolloutMetrics",
    "RolesConfig", "HandoffConfig", "PageStateError", "REPLICA_ROLES",
    "WrongRoleError", "HandoffError", "HandoffSizeError",
    "HandoffFrameError", "HandoffTimeoutError", "HandoffRejectedError",
    "HandoffRetryError", "HandoffSender", "HandoffReceiver",
    "SpillStore", "MemoryPressureGuard", "encode_spill_blob",
    "decode_spill_blob", "read_host_rss_mb", "AutoscaleConfig", "BreakerConfig",
    "DegradeConfig",
]
