"""Config keys and defaults: the subset of ``deepspeed_tpu/runtime/constants.py``
the port reads. Keys stay source-compatible, so configs port unchanged."""

TRAIN_BATCH_SIZE = "train_batch_size"
TRAIN_MICRO_BATCH_SIZE_PER_GPU = "train_micro_batch_size_per_gpu"
GRADIENT_ACCUMULATION_STEPS = "gradient_accumulation_steps"

ZERO_ALLOW_UNTESTED_OPTIMIZER = "zero_allow_untested_optimizer"
ZERO_ALLOW_UNTESTED_OPTIMIZER_DEFAULT = False

OPTIMIZER = "optimizer"
OPTIMIZER_PARAMS = "params"
TYPE = "type"
SCHEDULER = "scheduler"
SCHEDULER_TYPE_DEFAULT = None
SCHEDULER_PARAMS = "params"
MAX_GRAD_NORM = "max_grad_norm"

ADAM_OPTIMIZER = "adam"
ADAMW_OPTIMIZER = "adamw"
LAMB_OPTIMIZER = "lamb"
ONEBIT_ADAM_OPTIMIZER = "onebitadam"
SGD_OPTIMIZER = "sgd"
DEEPSPEED_OPTIMIZERS = [ADAM_OPTIMIZER, ADAMW_OPTIMIZER, LAMB_OPTIMIZER,
                        ONEBIT_ADAM_OPTIMIZER, SGD_OPTIMIZER]
# what the port runs; the rest raise NotImplementedError
PORTED_OPTIMIZERS = (ADAM_OPTIMIZER, ADAMW_OPTIMIZER, LAMB_OPTIMIZER, ONEBIT_ADAM_OPTIMIZER,
                     SGD_OPTIMIZER)

FP16 = "fp16"
FP16_ENABLED = "enabled"
FP16_LOSS_SCALE = "loss_scale"
FP16_LOSS_SCALE_DEFAULT = 0
FP16_INITIAL_SCALE_POWER = "initial_scale_power"
FP16_INITIAL_SCALE_POWER_DEFAULT = 32
FP16_LOSS_SCALE_WINDOW = "loss_scale_window"
FP16_LOSS_SCALE_WINDOW_DEFAULT = 1000
FP16_HYSTERESIS = "hysteresis"
FP16_HYSTERESIS_DEFAULT = 2
FP16_MIN_LOSS_SCALE = "min_loss_scale"
FP16_MIN_LOSS_SCALE_DEFAULT = 1
BFLOAT16 = "bf16"
BFLOAT16_ALIAS = "bfloat16"
BFLOAT16_ENABLED = "enabled"

GRADIENT_CLIPPING = "gradient_clipping"
GRADIENT_CLIPPING_DEFAULT = 0.0
# keys the JAX config parses and no engine of either package acts on
# beyond its accessor
DUMP_STATE = "dump_state"
DUMP_STATE_DEFAULT = False
DISABLE_ALLGATHER = "disable_allgather"
DISABLE_ALLGATHER_DEFAULT = False
ALLREDUCE_ALWAYS_FP32 = "allreduce_always_fp32"
ALLREDUCE_ALWAYS_FP32_DEFAULT = False
LEGACY_FUSION = "legacy_fusion"
LEGACY_FUSION_DEFAULT = False
AMP = "amp"
AMP_ENABLED = "enabled"
AMP_ENABLED_DEFAULT = False

PRESCALE_GRADIENTS = "prescale_gradients"
PRESCALE_GRADIENTS_DEFAULT = False
GRADIENT_PREDIVIDE_FACTOR = "gradient_predivide_factor"
GRADIENT_PREDIVIDE_FACTOR_DEFAULT = 1.0

STEPS_PER_PRINT = "steps_per_print"
STEPS_PER_PRINT_DEFAULT = 10

WALL_CLOCK_BREAKDOWN = "wall_clock_breakdown"
WALL_CLOCK_BREAKDOWN_DEFAULT = False

MEMORY_BREAKDOWN = "memory_breakdown"
MEMORY_BREAKDOWN_DEFAULT = False

# the monitors: tensorboard, and csv_monitor with the same keys and defaults
TENSORBOARD = "tensorboard"
TENSORBOARD_ENABLED = "enabled"
TENSORBOARD_ENABLED_DEFAULT = False
TENSORBOARD_OUTPUT_PATH = "output_path"
TENSORBOARD_OUTPUT_PATH_DEFAULT = ""
TENSORBOARD_JOB_NAME = "job_name"
TENSORBOARD_JOB_NAME_DEFAULT = "DeepSpeedTPUJobName"
CSV_MONITOR = "csv_monitor"
SEED = "seed"
SEED_DEFAULT = 42

# the checkpoint section: tag validation across ranks, and the storage
# keys of runtime/checkpoint/
CHECKPOINT = "checkpoint"
CHECKPOINT_TAG_VALIDATION = "tag_validation"
CHECKPOINT_TAG_VALIDATION_IGNORE = "IGNORE"
CHECKPOINT_TAG_VALIDATION_WARN = "WARN"
CHECKPOINT_TAG_VALIDATION_FAIL = "FAIL"
CHECKPOINT_TAG_VALIDATION_DEFAULT = CHECKPOINT_TAG_VALIDATION_WARN
CHECKPOINT_TAG_VALIDATION_MODES = [
    CHECKPOINT_TAG_VALIDATION_IGNORE,
    CHECKPOINT_TAG_VALIDATION_WARN,
    CHECKPOINT_TAG_VALIDATION_FAIL,
]
CHECKPOINT_KEEP_LAST_K = "keep_last_k"
CHECKPOINT_KEEP_LAST_K_DEFAULT = 0  # 0 = keep every committed tag
CHECKPOINT_MAX_RETRIES = "max_retries"
CHECKPOINT_MAX_RETRIES_DEFAULT = 3
CHECKPOINT_RETRY_BACKOFF = "retry_backoff_s"
CHECKPOINT_RETRY_BACKOFF_DEFAULT = 0.05
CHECKPOINT_VERIFY_ON_LOAD = "verify_on_load"
CHECKPOINT_VERIFY_ON_LOAD_DEFAULT = True
CHECKPOINT_FAULT_INJECTION = "fault_injection"

#############################################
# Resilience (runtime/resilience/ subsystem: divergence guard, hung-step
# watchdog, auto-rollback recovery). Opt-in: the block being present in the
# config enables it; absent means the engines run exactly as before.
#############################################
RESILIENCE = "resilience"
RESILIENCE_ENABLED = "enabled"
RESILIENCE_DIVERGENCE_CHECK = "divergence_check"
RESILIENCE_DIVERGENCE_CHECK_DEFAULT = True
RESILIENCE_SPIKE_WINDOW = "spike_window"
RESILIENCE_SPIKE_WINDOW_DEFAULT = 0  # 0 = no spike detection
RESILIENCE_SPIKE_THRESHOLD = "spike_threshold"
RESILIENCE_SPIKE_THRESHOLD_DEFAULT = 10.0  # x rolling median
RESILIENCE_MAX_RECOVERIES = "max_recoveries"
RESILIENCE_MAX_RECOVERIES_DEFAULT = 2
RESILIENCE_RECOVERY_BACKOFF = "recovery_backoff_s"
RESILIENCE_RECOVERY_BACKOFF_DEFAULT = 0.05
RESILIENCE_SKIP_POISONED_BATCHES = "skip_poisoned_batches"
RESILIENCE_SKIP_POISONED_BATCHES_DEFAULT = True
RESILIENCE_STEP_TIMEOUT = "step_timeout_s"
RESILIENCE_STEP_TIMEOUT_DEFAULT = 0.0  # 0 = watchdog off
RESILIENCE_FAULT_INJECTION = "fault_injection"
# Job-level (cluster) resilience: preemption-safe shutdown + host health
# gossip (runtime/resilience/preemption.py, comm/health.py).
RESILIENCE_HANDLE_PREEMPTION = "handle_preemption"
RESILIENCE_HANDLE_PREEMPTION_DEFAULT = False
RESILIENCE_PREEMPTION_SAVE_DIR = "preemption_save_dir"
RESILIENCE_PREEMPTION_SAVE_DIR_DEFAULT = None
RESILIENCE_GOSSIP_DIR = "gossip_dir"
RESILIENCE_GOSSIP_DIR_DEFAULT = None
RESILIENCE_PEER_TIMEOUT = "peer_timeout_s"
RESILIENCE_PEER_TIMEOUT_DEFAULT = 0.0  # 0 = gossip off
RESILIENCE_COMM_TIMEOUT = "comm_timeout_s"
RESILIENCE_COMM_TIMEOUT_DEFAULT = 0.0  # 0 = unbounded comm waits

# Progressive layer drop (runtime/progressive_layer_drop.py)
PROGRESSIVE_LAYER_DROP = "progressive_layer_drop"
PLD_ENABLED = "enabled"
PLD_ENABLED_DEFAULT = False
PLD_THETA = "theta"
PLD_THETA_DEFAULT = 1.0
PLD_GAMMA = "gamma"
PLD_GAMMA_DEFAULT = 0.001

# The continuous-batching serving engine (inference/serving/)
SERVING = "serving"
SERVING_ENABLED = "enabled"
SERVING_MAX_SLOTS = "max_slots"
SERVING_MAX_SLOTS_DEFAULT = 8
SERVING_MAX_QUEUE = "max_queue"
SERVING_MAX_QUEUE_DEFAULT = 64
SERVING_MAX_SEQ_LEN = "max_seq_len"
SERVING_MAX_SEQ_LEN_DEFAULT = None  # None = model max_position_embeddings
SERVING_PROMPT_BUCKETS = "prompt_buckets"
SERVING_PROMPT_BUCKETS_DEFAULT = None  # None = powers-of-two ladder
SERVING_DEFAULT_MAX_NEW_TOKENS = "default_max_new_tokens"
SERVING_DEFAULT_MAX_NEW_TOKENS_DEFAULT = 64
SERVING_REQUEST_TIMEOUT = "request_timeout_s"
SERVING_REQUEST_TIMEOUT_DEFAULT = 0.0  # 0 = no per-request deadline
SERVING_PREFILL_CHUNK_TOKENS = "prefill_chunk_tokens"
SERVING_PREFILL_CHUNK_TOKENS_DEFAULT = 0  # 0 = always single-pass prefill
SERVING_PREFIX_CACHE_MB = "prefix_cache_mb"
SERVING_PREFIX_CACHE_MB_DEFAULT = 0.0  # 0 = prefix KV cache disabled
SERVING_PREFIX_SPILL_MB = "prefix_spill_mb"
SERVING_PREFIX_SPILL_MB_DEFAULT = 0.0  # 0 = no spill tier (evict destroys)
SERVING_PREFIX_SPILL_DIR = "prefix_spill_dir"
SERVING_PREFIX_SPILL_DIR_DEFAULT = None  # None = no disk tier
SERVING_HOST_MEM_WATERMARK_MB = "host_mem_watermark_mb"
SERVING_HOST_MEM_WATERMARK_MB_DEFAULT = 0.0  # 0 = pressure guard off
SERVING_SPECULATIVE_K = "speculative_k"
SERVING_SPECULATIVE_K_DEFAULT = 0  # 0 = classic one-token decode
SERVING_KV_CACHE_DTYPE = "kv_cache_dtype"
SERVING_KV_CACHE_DTYPE_DEFAULT = "fp32"  # model compute dtype (bitwise)
SERVING_KV_CACHE_DTYPES = ("fp32", "bf16", "int8")
SERVING_FAULT_INJECTION = "fault_injection"
SERVING_ATTENTION_IMPL = "attention_impl"
SERVING_ATTENTION_IMPL_DEFAULT = None  # None = dense everywhere
SERVING_ATTENTION_IMPLS = ("dense", "flash", "sparse_xla",
                           "pallas_decode", "pallas_sparse")
SERVING_ATTENTION_KERNEL = "attention_kernel"
SERVING_ATTENTION_KERNEL_DEFAULT = None
SERVING_ATTENTION_KERNELS = ("pallas", "xla")
SERVING_KERNEL_INTERPRET = "kernel_interpret"
SERVING_KERNEL_INTERPRET_DEFAULT = None
SERVING_KV_PAGE_TOKENS = "kv_page_tokens"
SERVING_KV_PAGE_TOKENS_DEFAULT = None  # None = 128 (resolve_page_tokens)
SERVING_KV_POOL_TOKENS = "kv_pool_tokens"
SERVING_KV_POOL_TOKENS_DEFAULT = None  # None = max_slots * max_seq_len

# Fleet (inference/serving/router.py + replica.py: routing front-door
# over N supervised ServingEngine replicas). Opt-in like serving: the
# block being present enables it.
#############################################
FLEET = "fleet"
FLEET_ENABLED = "enabled"
FLEET_REPLICAS = "replicas"
FLEET_REPLICAS_DEFAULT = 2
FLEET_RETRY_BUDGET = "retry_budget"
FLEET_RETRY_BUDGET_DEFAULT = 2  # failure re-routes; rejections are free
FLEET_RETRY_BACKOFF = "retry_backoff_s"
FLEET_RETRY_BACKOFF_DEFAULT = 0.05
FLEET_RETRY_BACKOFF_MAX = "retry_backoff_max_s"
FLEET_RETRY_BACKOFF_MAX_DEFAULT = 2.0
FLEET_ATTEMPT_TIMEOUT = "attempt_timeout_s"
FLEET_ATTEMPT_TIMEOUT_DEFAULT = 120.0  # 0 = unbounded attempt waits
FLEET_DRAIN_TIMEOUT = "drain_timeout_s"
FLEET_DRAIN_TIMEOUT_DEFAULT = 30.0
FLEET_HEALTH_TTL = "health_ttl_s"
FLEET_HEALTH_TTL_DEFAULT = 0.25
FLEET_AFFINITY_PREFIX_TOKENS = "affinity_prefix_tokens"
FLEET_AFFINITY_PREFIX_TOKENS_DEFAULT = 16  # 0 = pure least-loaded
FLEET_SATURATION_QUEUE_DEPTH = "saturation_queue_depth"
FLEET_SATURATION_QUEUE_DEPTH_DEFAULT = 32
FLEET_MAX_INFLIGHT_TOKENS = "max_inflight_tokens"
FLEET_MAX_INFLIGHT_TOKENS_DEFAULT = 0  # 0 = unbounded; int or {class: n}
FLEET_SHED_RETRY_AFTER = "shed_retry_after_s"
FLEET_SHED_RETRY_AFTER_DEFAULT = 0.5

# fleet.autoscale: SLO-driven replica-count control loop
# (inference/serving/autoscaler.py). Opt-in by sub-block presence.
FLEET_AUTOSCALE = "autoscale"
FLEET_AUTOSCALE_ENABLED = "enabled"
FLEET_AUTOSCALE_MIN_REPLICAS = "min_replicas"
FLEET_AUTOSCALE_MIN_REPLICAS_DEFAULT = 1
FLEET_AUTOSCALE_MAX_REPLICAS = "max_replicas"
FLEET_AUTOSCALE_MAX_REPLICAS_DEFAULT = 4
FLEET_AUTOSCALE_WARM_SPARES = "warm_spares"
FLEET_AUTOSCALE_WARM_SPARES_DEFAULT = 1  # 0 = cold-start scale-up
FLEET_AUTOSCALE_UP_AFTER = "up_after_s"
FLEET_AUTOSCALE_UP_AFTER_DEFAULT = 1.0
FLEET_AUTOSCALE_DOWN_AFTER = "down_after_s"
FLEET_AUTOSCALE_DOWN_AFTER_DEFAULT = 5.0
FLEET_AUTOSCALE_COOLDOWN = "cooldown_s"
FLEET_AUTOSCALE_COOLDOWN_DEFAULT = 2.0
FLEET_AUTOSCALE_POLL_INTERVAL = "poll_interval_s"
FLEET_AUTOSCALE_POLL_INTERVAL_DEFAULT = 0.25

# fleet.degrade: degraded-mode ladder (inference/serving/degrade.py).
FLEET_DEGRADE = "degrade"
FLEET_DEGRADE_ENABLED = "enabled"
FLEET_DEGRADE_ESCALATE_AFTER = "escalate_after_s"
FLEET_DEGRADE_ESCALATE_AFTER_DEFAULT = 0.5
FLEET_DEGRADE_RECOVER_AFTER = "recover_after_s"
FLEET_DEGRADE_RECOVER_AFTER_DEFAULT = 2.0
FLEET_DEGRADE_PRESSURE_QUEUE_FRAC = "pressure_queue_frac"
FLEET_DEGRADE_PRESSURE_QUEUE_FRAC_DEFAULT = 0.75
FLEET_DEGRADE_SHED_CLASSES = "shed_classes"
FLEET_DEGRADE_SHED_CLASSES_DEFAULT = ()  # empty = all but "default"

# fleet.breaker: per-replica crash-loop circuit breakers
# (launcher/supervisor.py CrashLoopBreaker).
FLEET_BREAKER = "breaker"
FLEET_BREAKER_ENABLED = "enabled"
FLEET_BREAKER_THRESHOLD = "threshold"
FLEET_BREAKER_THRESHOLD_DEFAULT = 3
FLEET_BREAKER_WINDOW = "window_s"
FLEET_BREAKER_WINDOW_DEFAULT = 30.0
FLEET_BREAKER_COOLDOWN = "cooldown_s"
FLEET_BREAKER_COOLDOWN_DEFAULT = 5.0

# fleet.rollout: zero-downtime weight rollout state machine
# (inference/serving/rollout.py). Opt-in by sub-block presence.
FLEET_ROLLOUT = "rollout"
FLEET_ROLLOUT_ENABLED = "enabled"
FLEET_ROLLOUT_CANARY_FRACTION = "canary_fraction"
FLEET_ROLLOUT_CANARY_FRACTION_DEFAULT = 0.1
FLEET_ROLLOUT_CANARY_REPLICAS = "canary_replicas"
FLEET_ROLLOUT_CANARY_REPLICAS_DEFAULT = 1
FLEET_ROLLOUT_SHADOW_SAMPLE_RATE = "shadow_sample_rate"
FLEET_ROLLOUT_SHADOW_SAMPLE_RATE_DEFAULT = 0.25  # 0 = shadow mode off
FLEET_ROLLOUT_SHADOW_MAX_PENDING = "shadow_max_pending"
FLEET_ROLLOUT_SHADOW_MAX_PENDING_DEFAULT = 64
FLEET_ROLLOUT_CANARY_HOLD = "canary_hold_s"
FLEET_ROLLOUT_CANARY_HOLD_DEFAULT = 5.0
FLEET_ROLLOUT_MIN_CANARY_REQUESTS = "min_canary_requests"
FLEET_ROLLOUT_MIN_CANARY_REQUESTS_DEFAULT = 8
FLEET_ROLLOUT_MIN_SHADOW_COMPARED = "min_shadow_compared"
FLEET_ROLLOUT_MIN_SHADOW_COMPARED_DEFAULT = 4
FLEET_ROLLOUT_SHADOW_DIFF_THRESHOLD = "shadow_diff_threshold"
FLEET_ROLLOUT_SHADOW_DIFF_THRESHOLD_DEFAULT = 0.0  # any diff rolls back
FLEET_ROLLOUT_MAX_CANARY_CRASHES = "max_canary_crashes"
FLEET_ROLLOUT_MAX_CANARY_CRASHES_DEFAULT = 1
FLEET_ROLLOUT_ROLLBACK_ON = "rollback_on"
FLEET_ROLLOUT_ROLLBACK_ON_DEFAULT = (
    "slo_alert", "shadow_diff", "canary_crash")
FLEET_ROLLOUT_POLL_INTERVAL = "poll_interval_s"
FLEET_ROLLOUT_POLL_INTERVAL_DEFAULT = 0.5
FLEET_ROLLOUT_RECOVERY_BOUND = "recovery_bound_s"
FLEET_ROLLOUT_RECOVERY_BOUND_DEFAULT = 30.0

# fleet.roles: disaggregated prefill/decode role pools
# (inference/serving/router.py role scoring + autoscaler.py
# RolePoolAutoscaler). Opt-in by sub-block presence.
FLEET_ROLES = "roles"
FLEET_ROLES_ENABLED = "enabled"
FLEET_ROLES_PREFILL_REPLICAS = "prefill_replicas"
FLEET_ROLES_PREFILL_REPLICAS_DEFAULT = 1
FLEET_ROLES_DECODE_REPLICAS = "decode_replicas"
FLEET_ROLES_DECODE_REPLICAS_DEFAULT = 1
FLEET_ROLES_MAX_PREFILL_REPLICAS = "max_prefill_replicas"
FLEET_ROLES_MAX_PREFILL_REPLICAS_DEFAULT = 4
FLEET_ROLES_MAX_DECODE_REPLICAS = "max_decode_replicas"
FLEET_ROLES_MAX_DECODE_REPLICAS_DEFAULT = 4
# the role attribute values a replica may carry
FLEET_ROLE_VALUES = ("prefill", "decode", "mixed")

# fleet.handoff: crash-safe KV-page transfer between prefill and decode
# workers (inference/serving/handoff.py). Opt-in by sub-block presence.
FLEET_HANDOFF = "handoff"
FLEET_HANDOFF_ENABLED = "enabled"
FLEET_HANDOFF_MAX_FRAME_BYTES = "max_frame_bytes"
FLEET_HANDOFF_MAX_FRAME_BYTES_DEFAULT = 8 << 20
FLEET_HANDOFF_ATTEMPT_TIMEOUT = "attempt_timeout_s"
FLEET_HANDOFF_ATTEMPT_TIMEOUT_DEFAULT = 30.0
FLEET_HANDOFF_RETRIES = "retries"
FLEET_HANDOFF_RETRIES_DEFAULT = 3  # total attempts, >= 1
FLEET_HANDOFF_BACKOFF = "backoff_s"
FLEET_HANDOFF_BACKOFF_DEFAULT = 0.05
FLEET_HANDOFF_BACKOFF_MAX = "backoff_max_s"
FLEET_HANDOFF_BACKOFF_MAX_DEFAULT = 2.0
FLEET_HANDOFF_CLAIM_TTL = "claim_ttl_s"
FLEET_HANDOFF_CLAIM_TTL_DEFAULT = 30.0
FLEET_HANDOFF_RESUME_TTL = "resume_ttl_s"
FLEET_HANDOFF_RESUME_TTL_DEFAULT = 60.0

#############################################
# Sparse attention
#############################################
SPARSE_ATTENTION = "sparse_attention"
SPARSE_DENSE_MODE = "dense"
SPARSE_FIXED_MODE = "fixed"
SPARSE_VARIABLE_MODE = "variable"
SPARSE_BIGBIRD_MODE = "bigbird"
SPARSE_BSLONGFORMER_MODE = "bslongformer"
SPARSE_MODE = "mode"
SPARSE_MODE_DEFAULT = SPARSE_FIXED_MODE
SPARSE_BLOCK = "block"
SPARSE_BLOCK_DEFAULT = 16
SPARSE_DIFFERENT_LAYOUT_PER_HEAD = "different_layout_per_head"
SPARSE_DIFFERENT_LAYOUT_PER_HEAD_DEFAULT = False
SPARSE_NUM_LOCAL_BLOCKS = "num_local_blocks"
SPARSE_NUM_LOCAL_BLOCKS_DEFAULT = 4
SPARSE_NUM_GLOBAL_BLOCKS = "num_global_blocks"
SPARSE_NUM_GLOBAL_BLOCKS_DEFAULT = 1
SPARSE_ATTENTION_TYPE = "attention"
SPARSE_ATTENTION_TYPE_DEFAULT = "bidirectional"
SPARSE_HORIZONTAL_GLOBAL_ATTENTION = "horizontal_global_attention"
SPARSE_HORIZONTAL_GLOBAL_ATTENTION_DEFAULT = False
SPARSE_NUM_DIFFERENT_GLOBAL_PATTERNS = "num_different_global_patterns"
SPARSE_NUM_DIFFERENT_GLOBAL_PATTERNS_DEFAULT = 1
SPARSE_NUM_RANDOM_BLOCKS = "num_random_blocks"
SPARSE_NUM_RANDOM_BLOCKS_DEFAULT = 0
SPARSE_LOCAL_WINDOW_BLOCKS = "local_window_blocks"
SPARSE_LOCAL_WINDOW_BLOCKS_DEFAULT = [4]
SPARSE_GLOBAL_BLOCK_INDICES = "global_block_indices"
SPARSE_GLOBAL_BLOCK_INDICES_DEFAULT = [0]
SPARSE_GLOBAL_BLOCK_END_INDICES = "global_block_end_indices"
SPARSE_GLOBAL_BLOCK_END_INDICES_DEFAULT = None
SPARSE_NUM_SLIDING_WINDOW_BLOCKS = "num_sliding_window_blocks"
SPARSE_NUM_SLIDING_WINDOW_BLOCKS_DEFAULT = 3

# the pipeline section (the JAX package's keys and defaults; "executor"
# and "partition_method" pass through as given)
PIPELINE = "pipeline"
PIPELINE_STAGES = "stages"
PIPELINE_STAGES_DEFAULT = None
PIPELINE_PARTITION = "partition"
PIPELINE_PARTITION_DEFAULT = "best"
PIPELINE_SEED_LAYERS = "seed_layers"
PIPELINE_SEED_LAYERS_DEFAULT = False
PIPELINE_ACTIVATION_CHECKPOINT_INTERVAL = "activation_checkpoint_interval"
PIPELINE_ACTIVATION_CHECKPOINT_INTERVAL_DEFAULT = 0
PIPELINE_NUM_MODEL_CHUNKS = "num_model_chunks"
PIPELINE_NUM_MODEL_CHUNKS_DEFAULT = 1
PIPELINE_EXECUTOR = "executor"
PIPELINE_EXECUTOR_DEFAULT = "auto"

# the parallel section: the serving engine's tensor-parallel mesh and its
# sharding-registry overrides (the JAX package's keys and defaults)
PARALLEL = "parallel"
PARALLEL_ENABLED = "enabled"
PARALLEL_MESH_SHAPE = "mesh_shape"
PARALLEL_MESH_SHAPE_DEFAULT = (1, 1)  # (data, model); dict form allowed
PARALLEL_MESH_AXES = ("data", "model")  # axes mesh_shape may name
PARALLEL_PARTITION_RULES = "partition_rules"
PARALLEL_PARTITION_RULES_DEFAULT = None  # None = built-in registry rules
PARALLEL_REPLICATE_UNMATCHED = "replicate_unmatched"
PARALLEL_REPLICATE_UNMATCHED_DEFAULT = True

# sections and switches of the JAX config the port does not run yet: a
# config that enables one is refused by name (ROADMAP.md slice 9c)
UNPORTED_SECTIONS = ("curriculum_learning", "sparse_gradients")
