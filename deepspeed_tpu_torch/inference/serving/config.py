"""``ServingConfig``: the typed view of the ``serving`` config block, and
``FleetConfig`` with its sub-blocks (autoscale, degrade, breaker,
rollout, roles, handoff), the ``fleet`` block's.

Same fields and defaults as ``deepspeed_tpu/inference/serving/config.py``,
so a config carries over between the two packages. The tensor-parallel
mesh knobs (``mesh_shape``, ``partition_rules``, ``replicate_unmatched``)
arm the engine's serving mesh, one process a rank; the TPU-only kernel
knobs (``attention_kernel``, ``kernel_interpret``) accept only None.
"""

from dataclasses import dataclass, field


@dataclass
class ServingConfig:
    enabled: bool = False
    # KV-cache slots = max concurrent requests mid-decode; fixes the decode
    # step's batch dimension.
    max_slots: int = 8
    # Bounded admission queue; submit() past this raises QueueFullError.
    max_queue: int = 64
    # KV-cache length per slot (prompt + generated). None = the model's
    # max_position_embeddings.
    max_seq_len: int = None
    # Ascending prompt-length bucket ladder. None = powers of two up to
    # max_seq_len - 1.
    prompt_buckets: tuple = None
    default_max_new_tokens: int = 64
    # Default per-request deadline (queued + decoding); 0 = none.
    request_timeout_s: float = 0.0
    # Split prompts longer than this into chunks of this many tokens, one
    # chunk per engine step between decode steps; 0 = single-pass prefill.
    prefill_chunk_tokens: int = 0
    # Host-RAM budget of the prefix KV cache (MiB); 0 = off.
    prefix_cache_mb: float = 0.0
    # Spill tier under the live prefix cache: a host-RAM budget of framed
    # blobs (MiB) and an optional disk directory below it.
    prefix_spill_mb: float = 0.0
    prefix_spill_dir: str = None
    # Host RSS watermark of the memory-pressure guard (MiB); 0 = off.
    host_mem_watermark_mb: float = 0.0
    # Draft tokens verified a step by speculative decoding; 0 = off.
    speculative_k: int = 0
    # KV-pool storage dtype: "fp32" (the model's compute dtype), "bf16" or
    # "int8" (per-(slot, head) symmetric fp32 scales, dequantized at use).
    kv_cache_dtype: str = "fp32"
    # ServingFaultInjector spec (fault_injection.py); None = none armed.
    fault_injection: dict = field(default=None)
    # Attention backend: None/"dense", "pallas_decode", "pallas_sparse", or
    # a {bucket: impl} dict with an optional "default" key.
    attention_impl: object = None
    # TPU-only (Pallas vs XLA, interpret mode): must stay None.
    attention_kernel: str = None
    kernel_interpret: object = None
    # Tokens per KV page. None = 128 (adjusted to divide max_seq_len).
    kv_page_tokens: int = None
    # Total KV-pool token budget shared by all lanes. None =
    # max_slots * max_seq_len.
    kv_pool_tokens: int = None
    # Tensor-parallel mesh shape as (data, model), e.g. (1, 2): one process
    # a rank, each holding its heads of the layers and of the KV pool.
    # None = the single-device engine.
    mesh_shape: tuple = None
    # Ordered (path-regex, spec-elements) overrides consulted before the
    # registry's built-in SERVING_PARTITION_RULES (first match wins).
    partition_rules: tuple = None
    # Unmatched param-tree paths replicate instead of raising.
    replicate_unmatched: bool = True


@dataclass
class AutoscaleConfig:
    """The ``fleet.autoscale`` sub-block: the SLO-driven control loop
    (autoscaler.py). Opt-in: the sub-block's presence
    enables it."""

    enabled: bool = False
    # Fleet-size bounds the control loop may move between. Scale-down
    # never drains below min_replicas; scale-up never attaches past
    # max_replicas (past it, pressure escalates the degrade ladder
    # instead).
    min_replicas: int = 1
    max_replicas: int = 4
    # Pre-spawned replica processes kept listening but NOT routed to:
    # scale-up is attach-not-cold-start (the pool refills in the
    # background after an attach). 0 = cold-start scale-up.
    warm_spares: int = 1
    # Hysteresis: an alert must fire this long before a scale-up acts...
    up_after_s: float = 1.0
    # ...and the fleet must be alert-quiet this long before a scale-down.
    down_after_s: float = 5.0
    # Minimum gap between ANY two scaling actions (flap damping).
    cooldown_s: float = 2.0
    # Control-loop tick interval for the background thread.
    poll_interval_s: float = 0.25


@dataclass
class DegradeConfig:
    """The ``fleet.degrade`` sub-block: the degraded-mode ladder
    (degrade.py). Opt-in: presence enables."""

    enabled: bool = False
    # Sustained pressure before climbing ONE rung...
    escalate_after_s: float = 0.5
    # ...and sustained quiet before descending ONE rung (rung-by-rung
    # recovery; never a jump back to healthy).
    recover_after_s: float = 2.0
    # Engine-side pressure signal: queue_depth >= this fraction of
    # serving.max_queue counts as pressure for the automatic ladder.
    pressure_queue_frac: float = 0.75
    # Request classes the router sheds at rung 3. Empty = every class
    # EXCEPT "default" (the protected class).
    shed_classes: tuple = ()


@dataclass
class BreakerConfig:
    """The ``fleet.breaker`` sub-block: per-replica crash-loop circuit
    breakers (launcher/supervisor.py). Opt-in: presence enables."""

    enabled: bool = False
    # Failure exits (crash/hung/fatal — NOT clean or preempted) within
    # window_s that open the breaker.
    threshold: int = 3
    window_s: float = 30.0
    # Quarantine length while open: the worker stays down (the router
    # routes around its dead port), then ONE half-open probe restart is
    # allowed; a probe failure re-opens with a fresh cooldown.
    cooldown_s: float = 5.0


@dataclass
class RolloutConfig:
    """The ``fleet.rollout`` sub-block: zero-downtime weight rollout
    (rollout.py). Opt-in: presence enables."""

    enabled: bool = False
    # Fraction of NEW requests routed onto the canary generation while
    # the rollout is in its canary phase (deterministic prefix-hash
    # slice, so cache affinity survives the split).
    canary_fraction: float = 0.1
    # Replicas booted on the new weights for the canary phase.
    canary_replicas: int = 1
    # Fraction of completed live requests replayed against the canary as
    # shadow traffic (output-diffed against the incumbent's answer).
    # 0 = shadow mode off.
    shadow_sample_rate: float = 0.25
    # Bounded shadow backlog; beyond it, samples are dropped (shadowing
    # must never apply backpressure to live traffic).
    shadow_max_pending: int = 64
    # Canary soak gates before promotion: hold at least this long AND
    # carry at least this many canary-routed attempts AND (with
    # shadowing on) compare at least this many shadow replays.
    canary_hold_s: float = 5.0
    min_canary_requests: int = 8
    min_shadow_compared: int = 4
    # Shadow diff rate (diffs / compared) ABOVE this triggers rollback.
    # 0.0 = any diff at all rolls back (the bitwise-oracle default).
    shadow_diff_threshold: float = 0.0
    # Canary process deaths during canary/promote that trigger rollback.
    max_canary_crashes: int = 1
    # Which regression signals may trigger automatic rollback; subset of
    # {"slo_alert", "shadow_diff", "canary_crash"}.
    rollback_on: tuple = ("slo_alert", "shadow_diff", "canary_crash")
    # Manifest poll cadence of the background watch loop.
    poll_interval_s: float = 0.5
    # Rollback must restore a healthy single-generation fleet within
    # this bound (the chaos harness asserts it).
    recovery_bound_s: float = 30.0


@dataclass
class RolesConfig:
    """The ``fleet.roles`` sub-block: disaggregated prefill/decode
    role pools (router scoring + per-role autoscaling). Opt-in:
    presence enables."""

    enabled: bool = False
    # Replicas launched per role pool. A replica's own role still comes
    # from its spawn (--role / spec["role"]); these size launch/bench
    # wiring and the per-role autoscaler floors.
    prefill_replicas: int = 1
    decode_replicas: int = 1
    # Per-role autoscaler ceilings: TTFT pressure grows the prefill
    # pool, decode-throughput pressure grows the decode pool — two
    # control loops on two SLO signals.
    max_prefill_replicas: int = 4
    max_decode_replicas: int = 4


@dataclass
class HandoffConfig:
    """The ``fleet.handoff`` sub-block: the crash-safe KV-page transfer
    between prefill and decode workers (handoff.py).
    Opt-in: presence enables (role routing works without it via the
    defaults)."""

    enabled: bool = False
    # Hard cap on one binary page frame; an oversize length prefix is
    # refused (HandoffSizeError) before any payload is read.
    max_frame_bytes: int = 8 << 20
    # Per-attempt deadline over the whole claim→transfer→ack exchange.
    attempt_timeout_s: float = 30.0
    # Bounded retry: total attempts per handoff (>= 1), with exponential
    # backoff + jitter between them.
    retries: int = 3
    backoff_s: float = 0.05
    backoff_max_s: float = 2.0
    # Orphan-reaper TTLs on the decode side: a claim whose transfer
    # never finished (prefill death mid-handoff) is freed after
    # claim_ttl_s; an installed lane the router never resumed after
    # resume_ttl_s.
    claim_ttl_s: float = 30.0
    resume_ttl_s: float = 60.0


@dataclass
class FleetConfig:
    """The ``fleet`` block: router + replica-fleet policy
    (router.py, replica.py). Opt-in like ``serving``:
    the block's presence enables it."""

    # Master switch: True once a `fleet` section exists (see
    # get_fleet_config), False when absent.
    enabled: bool = False
    # Replica processes the launch path spawns (the router itself
    # accepts any endpoint list; this sizes launch/bench wiring).
    replicas: int = 2
    # Re-route attempts per request after a replica FAILURE (death, EOF,
    # attempt timeout). Rejections (queue-full / draining / injected) do
    # NOT consume the budget — they re-route immediately. Exhausting it
    # quarantines the request with RequestPoisonedError.
    retry_budget: int = 2
    # Exponential backoff between failure retries: base * 2^attempt,
    # jittered, capped at retry_backoff_max_s.
    retry_backoff_s: float = 0.05
    retry_backoff_max_s: float = 2.0
    # Per-attempt socket inactivity deadline (no token / reply for this
    # long = the replica is wedged; fail the attempt and re-route).
    # 0 = wait forever. Must exceed worst-case cold prefill compile.
    attempt_timeout_s: float = 120.0
    # Replica-side drain deadline on SIGTERM: finish in-flight work for
    # at most this long, then exit EXIT_PREEMPTED regardless.
    drain_timeout_s: float = 30.0
    # Router-side health probe cache TTL: /healthz + /snapshot scrapes
    # are at most this stale when scoring replicas.
    health_ttl_s: float = 0.25
    # Prefix-affinity hash length (tokens): requests sharing their first
    # N tokens route to the same replica so the prefix KV cache keeps
    # hitting after scale-out. 0 disables affinity (pure least-loaded).
    affinity_prefix_tokens: int = 16
    # A replica with queue_depth + active_requests >= this is saturated:
    # affinity falls back to least-loaded, and when EVERY healthy
    # replica is saturated the router sheds with FleetOverloadError.
    saturation_queue_depth: int = 32
    # Admission-controller token budgets (prompt + max_new_tokens of
    # everything in flight through the router): an int caps every
    # request class; a {class: budget} dict (optional "default" key)
    # caps per class. 0 = unbounded.
    max_inflight_tokens: object = 0
    # retry-after hint carried by FleetOverloadError on shed.
    shed_retry_after_s: float = 0.5
    # Self-healing sub-blocks (autoscaler control loop, degraded-mode
    # ladder, crash-loop breakers). Each is opt-in by presence, like the
    # fleet block itself.
    autoscale: AutoscaleConfig = field(default_factory=AutoscaleConfig)
    degrade: DegradeConfig = field(default_factory=DegradeConfig)
    breaker: BreakerConfig = field(default_factory=BreakerConfig)
    rollout: RolloutConfig = field(default_factory=RolloutConfig)
    roles: RolesConfig = field(default_factory=RolesConfig)
    handoff: HandoffConfig = field(default_factory=HandoffConfig)

