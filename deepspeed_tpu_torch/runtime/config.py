"""Top-level typed config.

Port of ``deepspeed_tpu/runtime/config.py`` for the training path: JSON
file or dict in, typed config out; the batch triple
``train_batch = micro_batch x grad_accum x world_size`` is inferred and
checked with the JAX class's errors; duplicate JSON keys and fp16 + bf16
are refused. ``world_size`` is the data-parallel world size: the
``torch.distributed`` world size when it is initialized, else 1.

Honoured sections: ``optimizer`` (Adam, AdamW, Lamb, SGD), ``scheduler``
(name and params), ``fp16`` (static or dynamic loss scaling) and
``bf16``, ``gradient_clipping``, ``zero_optimization`` (stages 0-3 and
``cpu_offload``, with the JAX package's checks of its keys) and
``zero_allow_untested_optimizer``, ``activation_checkpointing`` (every
key), ``tensorboard``, ``csv_monitor``, ``wall_clock_breakdown``,
``memory_breakdown``, ``steps_per_print``, ``seed``, ``prescale_gradients``,
``gradient_predivide_factor``, ``checkpoint`` (tag validation and the
storage keys of ``runtime/checkpoint/``), ``telemetry`` (the copied
``DeepSpeedTelemetryConfig``), ``serving``, ``fleet`` (the serving
fleet's router, replicas and their sub-blocks), ``pipeline`` (the JAX
package's keys; ``num_model_chunks`` checked as there) and ``elasticity``,
which overrides the batch parameters before the triple is inferred. A
config that enables a section or a switch the port does not run yet
raises ``NotImplementedError`` naming it; nothing is silently ignored.
"""

import json
import os
import re
from dataclasses import dataclass

import torch

from deepspeed_tpu_torch.runtime.activation_checkpointing.config import (
    DeepSpeedActivationCheckpointingConfig,
)
from deepspeed_tpu_torch.runtime.config_utils import (
    dict_raise_error_on_duplicate_keys,
    get_scalar_param,
)
from deepspeed_tpu_torch.elasticity import (
    compute_elastic_config,
    elasticity_enabled,
    ensure_immutable_elastic_config,
)
from deepspeed_tpu_torch.elasticity.config import ElasticityConfigError
from deepspeed_tpu_torch.elasticity.constants import (
    ELASTICITY,
    IGNORE_NON_ELASTIC_BATCH_INFO,
    IGNORE_NON_ELASTIC_BATCH_INFO_DEFAULT,
)
from deepspeed_tpu_torch.runtime.checkpoint import CheckpointConfig
from deepspeed_tpu_torch.runtime.constants import (
    PIPELINE,
    PIPELINE_ACTIVATION_CHECKPOINT_INTERVAL,
    PIPELINE_ACTIVATION_CHECKPOINT_INTERVAL_DEFAULT,
    PIPELINE_NUM_MODEL_CHUNKS,
    PIPELINE_NUM_MODEL_CHUNKS_DEFAULT,
    PIPELINE_PARTITION,
    PIPELINE_PARTITION_DEFAULT,
    PIPELINE_SEED_LAYERS,
    PIPELINE_SEED_LAYERS_DEFAULT,
    PIPELINE_STAGES,
    PIPELINE_STAGES_DEFAULT,
    FLEET,
    FLEET_AFFINITY_PREFIX_TOKENS,
    FLEET_AFFINITY_PREFIX_TOKENS_DEFAULT,
    FLEET_ATTEMPT_TIMEOUT,
    FLEET_ATTEMPT_TIMEOUT_DEFAULT,
    FLEET_AUTOSCALE,
    FLEET_AUTOSCALE_COOLDOWN,
    FLEET_AUTOSCALE_COOLDOWN_DEFAULT,
    FLEET_AUTOSCALE_DOWN_AFTER,
    FLEET_AUTOSCALE_DOWN_AFTER_DEFAULT,
    FLEET_AUTOSCALE_ENABLED,
    FLEET_AUTOSCALE_MAX_REPLICAS,
    FLEET_AUTOSCALE_MAX_REPLICAS_DEFAULT,
    FLEET_AUTOSCALE_MIN_REPLICAS,
    FLEET_AUTOSCALE_MIN_REPLICAS_DEFAULT,
    FLEET_AUTOSCALE_POLL_INTERVAL,
    FLEET_AUTOSCALE_POLL_INTERVAL_DEFAULT,
    FLEET_AUTOSCALE_UP_AFTER,
    FLEET_AUTOSCALE_UP_AFTER_DEFAULT,
    FLEET_AUTOSCALE_WARM_SPARES,
    FLEET_AUTOSCALE_WARM_SPARES_DEFAULT,
    FLEET_BREAKER,
    FLEET_BREAKER_COOLDOWN,
    FLEET_BREAKER_COOLDOWN_DEFAULT,
    FLEET_BREAKER_ENABLED,
    FLEET_BREAKER_THRESHOLD,
    FLEET_BREAKER_THRESHOLD_DEFAULT,
    FLEET_BREAKER_WINDOW,
    FLEET_BREAKER_WINDOW_DEFAULT,
    FLEET_DEGRADE,
    FLEET_DEGRADE_ENABLED,
    FLEET_DEGRADE_ESCALATE_AFTER,
    FLEET_DEGRADE_ESCALATE_AFTER_DEFAULT,
    FLEET_DEGRADE_PRESSURE_QUEUE_FRAC,
    FLEET_DEGRADE_PRESSURE_QUEUE_FRAC_DEFAULT,
    FLEET_DEGRADE_RECOVER_AFTER,
    FLEET_DEGRADE_RECOVER_AFTER_DEFAULT,
    FLEET_DEGRADE_SHED_CLASSES,
    FLEET_DEGRADE_SHED_CLASSES_DEFAULT,
    FLEET_DRAIN_TIMEOUT,
    FLEET_DRAIN_TIMEOUT_DEFAULT,
    FLEET_ENABLED,
    FLEET_HANDOFF,
    FLEET_HANDOFF_ATTEMPT_TIMEOUT,
    FLEET_HANDOFF_ATTEMPT_TIMEOUT_DEFAULT,
    FLEET_HANDOFF_BACKOFF,
    FLEET_HANDOFF_BACKOFF_DEFAULT,
    FLEET_HANDOFF_BACKOFF_MAX,
    FLEET_HANDOFF_BACKOFF_MAX_DEFAULT,
    FLEET_HANDOFF_CLAIM_TTL,
    FLEET_HANDOFF_CLAIM_TTL_DEFAULT,
    FLEET_HANDOFF_ENABLED,
    FLEET_HANDOFF_MAX_FRAME_BYTES,
    FLEET_HANDOFF_MAX_FRAME_BYTES_DEFAULT,
    FLEET_HANDOFF_RESUME_TTL,
    FLEET_HANDOFF_RESUME_TTL_DEFAULT,
    FLEET_HANDOFF_RETRIES,
    FLEET_HANDOFF_RETRIES_DEFAULT,
    FLEET_HEALTH_TTL,
    FLEET_HEALTH_TTL_DEFAULT,
    FLEET_MAX_INFLIGHT_TOKENS,
    FLEET_MAX_INFLIGHT_TOKENS_DEFAULT,
    FLEET_REPLICAS,
    FLEET_REPLICAS_DEFAULT,
    FLEET_RETRY_BACKOFF,
    FLEET_RETRY_BACKOFF_DEFAULT,
    FLEET_RETRY_BACKOFF_MAX,
    FLEET_RETRY_BACKOFF_MAX_DEFAULT,
    FLEET_RETRY_BUDGET,
    FLEET_RETRY_BUDGET_DEFAULT,
    FLEET_ROLES,
    FLEET_ROLES_DECODE_REPLICAS,
    FLEET_ROLES_DECODE_REPLICAS_DEFAULT,
    FLEET_ROLES_ENABLED,
    FLEET_ROLES_MAX_DECODE_REPLICAS,
    FLEET_ROLES_MAX_DECODE_REPLICAS_DEFAULT,
    FLEET_ROLES_MAX_PREFILL_REPLICAS,
    FLEET_ROLES_MAX_PREFILL_REPLICAS_DEFAULT,
    FLEET_ROLES_PREFILL_REPLICAS,
    FLEET_ROLES_PREFILL_REPLICAS_DEFAULT,
    FLEET_ROLLOUT,
    FLEET_ROLLOUT_CANARY_FRACTION,
    FLEET_ROLLOUT_CANARY_FRACTION_DEFAULT,
    FLEET_ROLLOUT_CANARY_HOLD,
    FLEET_ROLLOUT_CANARY_HOLD_DEFAULT,
    FLEET_ROLLOUT_CANARY_REPLICAS,
    FLEET_ROLLOUT_CANARY_REPLICAS_DEFAULT,
    FLEET_ROLLOUT_ENABLED,
    FLEET_ROLLOUT_MAX_CANARY_CRASHES,
    FLEET_ROLLOUT_MAX_CANARY_CRASHES_DEFAULT,
    FLEET_ROLLOUT_MIN_CANARY_REQUESTS,
    FLEET_ROLLOUT_MIN_CANARY_REQUESTS_DEFAULT,
    FLEET_ROLLOUT_MIN_SHADOW_COMPARED,
    FLEET_ROLLOUT_MIN_SHADOW_COMPARED_DEFAULT,
    FLEET_ROLLOUT_POLL_INTERVAL,
    FLEET_ROLLOUT_POLL_INTERVAL_DEFAULT,
    FLEET_ROLLOUT_RECOVERY_BOUND,
    FLEET_ROLLOUT_RECOVERY_BOUND_DEFAULT,
    FLEET_ROLLOUT_ROLLBACK_ON,
    FLEET_ROLLOUT_ROLLBACK_ON_DEFAULT,
    FLEET_ROLLOUT_SHADOW_DIFF_THRESHOLD,
    FLEET_ROLLOUT_SHADOW_DIFF_THRESHOLD_DEFAULT,
    FLEET_ROLLOUT_SHADOW_MAX_PENDING,
    FLEET_ROLLOUT_SHADOW_MAX_PENDING_DEFAULT,
    FLEET_ROLLOUT_SHADOW_SAMPLE_RATE,
    FLEET_ROLLOUT_SHADOW_SAMPLE_RATE_DEFAULT,
    FLEET_SATURATION_QUEUE_DEPTH,
    FLEET_SATURATION_QUEUE_DEPTH_DEFAULT,
    FLEET_SHED_RETRY_AFTER,
    FLEET_SHED_RETRY_AFTER_DEFAULT,
    BFLOAT16,
    BFLOAT16_ALIAS,
    BFLOAT16_ENABLED,
    CHECKPOINT,
    CHECKPOINT_FAULT_INJECTION,
    CHECKPOINT_KEEP_LAST_K,
    CHECKPOINT_KEEP_LAST_K_DEFAULT,
    CHECKPOINT_MAX_RETRIES,
    CHECKPOINT_MAX_RETRIES_DEFAULT,
    CHECKPOINT_RETRY_BACKOFF,
    CHECKPOINT_RETRY_BACKOFF_DEFAULT,
    CHECKPOINT_TAG_VALIDATION,
    CHECKPOINT_TAG_VALIDATION_DEFAULT,
    CHECKPOINT_TAG_VALIDATION_FAIL,
    CHECKPOINT_TAG_VALIDATION_IGNORE,
    CHECKPOINT_TAG_VALIDATION_MODES,
    CHECKPOINT_VERIFY_ON_LOAD,
    CHECKPOINT_VERIFY_ON_LOAD_DEFAULT,
    DEEPSPEED_OPTIMIZERS,
    FP16,
    FP16_ENABLED,
    FP16_HYSTERESIS,
    FP16_HYSTERESIS_DEFAULT,
    FP16_INITIAL_SCALE_POWER,
    FP16_INITIAL_SCALE_POWER_DEFAULT,
    FP16_LOSS_SCALE,
    FP16_LOSS_SCALE_DEFAULT,
    FP16_LOSS_SCALE_WINDOW,
    FP16_LOSS_SCALE_WINDOW_DEFAULT,
    FP16_MIN_LOSS_SCALE,
    FP16_MIN_LOSS_SCALE_DEFAULT,
    GRADIENT_ACCUMULATION_STEPS,
    GRADIENT_CLIPPING,
    GRADIENT_CLIPPING_DEFAULT,
    GRADIENT_PREDIVIDE_FACTOR,
    GRADIENT_PREDIVIDE_FACTOR_DEFAULT,
    OPTIMIZER,
    OPTIMIZER_PARAMS,
    PORTED_OPTIMIZERS,
    PRESCALE_GRADIENTS,
    PRESCALE_GRADIENTS_DEFAULT,
    RESILIENCE,
    RESILIENCE_COMM_TIMEOUT,
    RESILIENCE_COMM_TIMEOUT_DEFAULT,
    RESILIENCE_DIVERGENCE_CHECK,
    RESILIENCE_DIVERGENCE_CHECK_DEFAULT,
    RESILIENCE_ENABLED,
    RESILIENCE_FAULT_INJECTION,
    RESILIENCE_GOSSIP_DIR,
    RESILIENCE_GOSSIP_DIR_DEFAULT,
    RESILIENCE_HANDLE_PREEMPTION,
    RESILIENCE_HANDLE_PREEMPTION_DEFAULT,
    RESILIENCE_MAX_RECOVERIES,
    RESILIENCE_MAX_RECOVERIES_DEFAULT,
    RESILIENCE_PEER_TIMEOUT,
    RESILIENCE_PEER_TIMEOUT_DEFAULT,
    RESILIENCE_PREEMPTION_SAVE_DIR,
    RESILIENCE_PREEMPTION_SAVE_DIR_DEFAULT,
    RESILIENCE_RECOVERY_BACKOFF,
    RESILIENCE_RECOVERY_BACKOFF_DEFAULT,
    RESILIENCE_SKIP_POISONED_BATCHES,
    RESILIENCE_SKIP_POISONED_BATCHES_DEFAULT,
    RESILIENCE_SPIKE_THRESHOLD,
    RESILIENCE_SPIKE_THRESHOLD_DEFAULT,
    RESILIENCE_SPIKE_WINDOW,
    RESILIENCE_SPIKE_WINDOW_DEFAULT,
    RESILIENCE_STEP_TIMEOUT,
    RESILIENCE_STEP_TIMEOUT_DEFAULT,
    SCHEDULER,
    SCHEDULER_PARAMS,
    SCHEDULER_TYPE_DEFAULT,
    SEED,
    SEED_DEFAULT,
    SPARSE_ATTENTION,
    SPARSE_ATTENTION_TYPE,
    SPARSE_ATTENTION_TYPE_DEFAULT,
    SPARSE_BIGBIRD_MODE,
    SPARSE_BLOCK,
    SPARSE_BLOCK_DEFAULT,
    SPARSE_BSLONGFORMER_MODE,
    SPARSE_DENSE_MODE,
    SPARSE_DIFFERENT_LAYOUT_PER_HEAD,
    SPARSE_DIFFERENT_LAYOUT_PER_HEAD_DEFAULT,
    SPARSE_FIXED_MODE,
    SPARSE_GLOBAL_BLOCK_END_INDICES,
    SPARSE_GLOBAL_BLOCK_END_INDICES_DEFAULT,
    SPARSE_GLOBAL_BLOCK_INDICES,
    SPARSE_GLOBAL_BLOCK_INDICES_DEFAULT,
    SPARSE_HORIZONTAL_GLOBAL_ATTENTION,
    SPARSE_HORIZONTAL_GLOBAL_ATTENTION_DEFAULT,
    SPARSE_LOCAL_WINDOW_BLOCKS,
    SPARSE_LOCAL_WINDOW_BLOCKS_DEFAULT,
    SPARSE_MODE,
    SPARSE_MODE_DEFAULT,
    SPARSE_NUM_DIFFERENT_GLOBAL_PATTERNS,
    SPARSE_NUM_DIFFERENT_GLOBAL_PATTERNS_DEFAULT,
    SPARSE_NUM_GLOBAL_BLOCKS,
    SPARSE_NUM_GLOBAL_BLOCKS_DEFAULT,
    SPARSE_NUM_LOCAL_BLOCKS,
    SPARSE_NUM_LOCAL_BLOCKS_DEFAULT,
    SPARSE_NUM_RANDOM_BLOCKS,
    SPARSE_NUM_RANDOM_BLOCKS_DEFAULT,
    SPARSE_NUM_SLIDING_WINDOW_BLOCKS,
    SPARSE_NUM_SLIDING_WINDOW_BLOCKS_DEFAULT,
    SPARSE_VARIABLE_MODE,
    STEPS_PER_PRINT,
    STEPS_PER_PRINT_DEFAULT,
    CSV_MONITOR,
    MEMORY_BREAKDOWN,
    MEMORY_BREAKDOWN_DEFAULT,
    ALLREDUCE_ALWAYS_FP32,
    ALLREDUCE_ALWAYS_FP32_DEFAULT,
    AMP,
    AMP_ENABLED,
    AMP_ENABLED_DEFAULT,
    DISABLE_ALLGATHER,
    DISABLE_ALLGATHER_DEFAULT,
    DUMP_STATE,
    DUMP_STATE_DEFAULT,
    LEGACY_FUSION,
    LEGACY_FUSION_DEFAULT,
    TENSORBOARD,
    TENSORBOARD_ENABLED,
    TENSORBOARD_ENABLED_DEFAULT,
    TENSORBOARD_JOB_NAME,
    TENSORBOARD_JOB_NAME_DEFAULT,
    TENSORBOARD_OUTPUT_PATH,
    TENSORBOARD_OUTPUT_PATH_DEFAULT,
    WALL_CLOCK_BREAKDOWN,
    WALL_CLOCK_BREAKDOWN_DEFAULT,
    TRAIN_BATCH_SIZE,
    TRAIN_MICRO_BATCH_SIZE_PER_GPU,
    TYPE,
    UNPORTED_SECTIONS,
    PLD_ENABLED,
    PLD_ENABLED_DEFAULT,
    PLD_GAMMA,
    PLD_GAMMA_DEFAULT,
    PLD_THETA,
    PLD_THETA_DEFAULT,
    PROGRESSIVE_LAYER_DROP,
    SERVING,
    SERVING_ATTENTION_IMPL,
    SERVING_ATTENTION_IMPL_DEFAULT,
    SERVING_ATTENTION_IMPLS,
    SERVING_ATTENTION_KERNEL,
    SERVING_ATTENTION_KERNEL_DEFAULT,
    SERVING_ATTENTION_KERNELS,
    SERVING_DEFAULT_MAX_NEW_TOKENS,
    SERVING_DEFAULT_MAX_NEW_TOKENS_DEFAULT,
    SERVING_ENABLED,
    SERVING_FAULT_INJECTION,
    SERVING_HOST_MEM_WATERMARK_MB,
    SERVING_HOST_MEM_WATERMARK_MB_DEFAULT,
    SERVING_KERNEL_INTERPRET,
    SERVING_KERNEL_INTERPRET_DEFAULT,
    SERVING_KV_CACHE_DTYPE,
    SERVING_KV_CACHE_DTYPE_DEFAULT,
    SERVING_KV_CACHE_DTYPES,
    SERVING_KV_PAGE_TOKENS,
    SERVING_KV_PAGE_TOKENS_DEFAULT,
    SERVING_KV_POOL_TOKENS,
    SERVING_KV_POOL_TOKENS_DEFAULT,
    SERVING_MAX_QUEUE,
    SERVING_MAX_QUEUE_DEFAULT,
    SERVING_MAX_SEQ_LEN,
    SERVING_MAX_SEQ_LEN_DEFAULT,
    SERVING_MAX_SLOTS,
    SERVING_MAX_SLOTS_DEFAULT,
    SERVING_PREFILL_CHUNK_TOKENS,
    SERVING_PREFILL_CHUNK_TOKENS_DEFAULT,
    SERVING_PREFIX_CACHE_MB,
    SERVING_PREFIX_CACHE_MB_DEFAULT,
    SERVING_PREFIX_SPILL_DIR,
    SERVING_PREFIX_SPILL_DIR_DEFAULT,
    SERVING_PREFIX_SPILL_MB,
    SERVING_PREFIX_SPILL_MB_DEFAULT,
    SERVING_PROMPT_BUCKETS,
    SERVING_PROMPT_BUCKETS_DEFAULT,
    SERVING_REQUEST_TIMEOUT,
    SERVING_REQUEST_TIMEOUT_DEFAULT,
    SERVING_SPECULATIVE_K,
    SERVING_SPECULATIVE_K_DEFAULT,
    ZERO_ALLOW_UNTESTED_OPTIMIZER,
    ZERO_ALLOW_UNTESTED_OPTIMIZER_DEFAULT,
    PARALLEL,
    PARALLEL_ENABLED,
    PARALLEL_MESH_AXES,
    PARALLEL_MESH_SHAPE,
    PARALLEL_MESH_SHAPE_DEFAULT,
    PARALLEL_PARTITION_RULES,
    PARALLEL_PARTITION_RULES_DEFAULT,
    PARALLEL_REPLICATE_UNMATCHED,
    PARALLEL_REPLICATE_UNMATCHED_DEFAULT,
)
from deepspeed_tpu_torch.profiling.config import (
    DeepSpeedFlopsProfilerConfig,
    DeepSpeedSentinelConfig,
)
from deepspeed_tpu_torch.runtime.resilience.config import ResilienceConfig
from deepspeed_tpu_torch.runtime.zero.config import DeepSpeedZeroConfig
from deepspeed_tpu_torch.runtime.zero.constants import (
    MAX_STAGE_ZERO_OPTIMIZATION,
    ZERO_OPTIMIZATION_DISABLED,
)
from deepspeed_tpu_torch.telemetry.config import DeepSpeedTelemetryConfig
from deepspeed_tpu_torch.utils.logging import logger
from deepspeed_tpu_torch.version import __version__


class DeepSpeedConfigError(Exception):
    pass


def _section_enabled(param_dict, key):
    """A section counts as enabled when present, unless it says
    ``"enabled": false``."""
    section = param_dict.get(key)
    if section is None:
        return False
    if isinstance(section, dict):
        return bool(section.get("enabled", True))
    return bool(section)


def get_wall_clock_breakdown(param_dict):
    return get_scalar_param(param_dict, WALL_CLOCK_BREAKDOWN, WALL_CLOCK_BREAKDOWN_DEFAULT)


def get_memory_breakdown(param_dict):
    return get_scalar_param(param_dict, MEMORY_BREAKDOWN, MEMORY_BREAKDOWN_DEFAULT)


def get_tensorboard_enabled(param_dict):
    if TENSORBOARD in param_dict:
        return get_scalar_param(param_dict[TENSORBOARD], TENSORBOARD_ENABLED,
                                TENSORBOARD_ENABLED_DEFAULT)
    return False


def get_tensorboard_output_path(param_dict):
    if get_tensorboard_enabled(param_dict):
        return get_scalar_param(param_dict[TENSORBOARD], TENSORBOARD_OUTPUT_PATH,
                                TENSORBOARD_OUTPUT_PATH_DEFAULT)
    return TENSORBOARD_OUTPUT_PATH_DEFAULT


def get_tensorboard_job_name(param_dict):
    if get_tensorboard_enabled(param_dict):
        return get_scalar_param(param_dict[TENSORBOARD], TENSORBOARD_JOB_NAME,
                                TENSORBOARD_JOB_NAME_DEFAULT)
    return TENSORBOARD_JOB_NAME_DEFAULT


def get_csv_monitor(param_dict):
    """The ``csv_monitor`` section: (enabled, output_path, job_name), with
    the tensorboard section's defaults."""
    sec = param_dict.get(CSV_MONITOR, {})
    return (bool(sec.get("enabled", False)),
            sec.get("output_path", TENSORBOARD_OUTPUT_PATH_DEFAULT),
            sec.get("job_name", TENSORBOARD_JOB_NAME_DEFAULT))


def get_fp16_enabled(param_dict):
    if FP16 in param_dict:
        return get_scalar_param(param_dict[FP16], FP16_ENABLED, False)
    return False


def get_loss_scale(param_dict):
    if get_fp16_enabled(param_dict):
        return get_scalar_param(param_dict[FP16], FP16_LOSS_SCALE, FP16_LOSS_SCALE_DEFAULT)
    return FP16_LOSS_SCALE_DEFAULT


def get_initial_dynamic_scale(param_dict):
    if get_fp16_enabled(param_dict):
        initial_scale_power = get_scalar_param(
            param_dict[FP16], FP16_INITIAL_SCALE_POWER, FP16_INITIAL_SCALE_POWER_DEFAULT)
    else:
        initial_scale_power = FP16_INITIAL_SCALE_POWER_DEFAULT
    return 2**initial_scale_power


def get_dynamic_loss_scale_args(param_dict):
    """The dynamic scaler's arguments when the fp16 section names any of
    them, else None (the engine then takes its own defaults)."""
    if not get_fp16_enabled(param_dict):
        return None
    fp16_dict = param_dict[FP16]
    dynamic_props = [FP16_INITIAL_SCALE_POWER, FP16_LOSS_SCALE_WINDOW, FP16_MIN_LOSS_SCALE,
                     FP16_HYSTERESIS]
    if not any(d in fp16_dict for d in dynamic_props):
        return None
    return {
        "init_scale": 2**get_scalar_param(fp16_dict, FP16_INITIAL_SCALE_POWER,
                                          FP16_INITIAL_SCALE_POWER_DEFAULT),
        "scale_window": get_scalar_param(fp16_dict, FP16_LOSS_SCALE_WINDOW,
                                         FP16_LOSS_SCALE_WINDOW_DEFAULT),
        "delayed_shift": get_scalar_param(fp16_dict, FP16_HYSTERESIS,
                                          FP16_HYSTERESIS_DEFAULT),
        "min_scale": get_scalar_param(fp16_dict, FP16_MIN_LOSS_SCALE,
                                      FP16_MIN_LOSS_SCALE_DEFAULT),
    }


def get_bfloat16_enabled(param_dict):
    for key in (BFLOAT16, BFLOAT16_ALIAS):
        if key in param_dict:
            return get_scalar_param(param_dict[key], BFLOAT16_ENABLED, False)
    return False


def get_optimizer_name(param_dict):
    if OPTIMIZER in param_dict and TYPE in param_dict[OPTIMIZER]:
        return param_dict[OPTIMIZER][TYPE]
    return None


def get_optimizer_legacy_fusion(param_dict):
    if OPTIMIZER in param_dict and LEGACY_FUSION in param_dict[OPTIMIZER]:
        return param_dict[OPTIMIZER][LEGACY_FUSION]
    return LEGACY_FUSION_DEFAULT


def get_amp_enabled(param_dict):
    if AMP in param_dict:
        return get_scalar_param(param_dict[AMP], AMP_ENABLED, AMP_ENABLED_DEFAULT)
    return False


def get_amp_params(param_dict):
    if AMP in param_dict:
        amp_params = dict(param_dict[AMP])
        amp_params.pop(AMP_ENABLED, None)
        return amp_params
    return False


def get_optimizer_params(param_dict):
    if get_optimizer_name(param_dict) is not None and OPTIMIZER_PARAMS in param_dict[OPTIMIZER]:
        return param_dict[OPTIMIZER][OPTIMIZER_PARAMS]
    return None


def get_scheduler_name(param_dict):
    if SCHEDULER in param_dict and TYPE in param_dict[SCHEDULER]:
        return param_dict[SCHEDULER][TYPE]
    return SCHEDULER_TYPE_DEFAULT


def get_scheduler_params(param_dict):
    if get_scheduler_name(param_dict) is not None and SCHEDULER_PARAMS in param_dict[SCHEDULER]:
        return param_dict[SCHEDULER][SCHEDULER_PARAMS]
    return None


def get_checkpoint_tag_validation_mode(param_dict):
    """checkpoint: {tag_validation: Ignore|Warn|Fail}."""
    checkpoint_params = param_dict.get(CHECKPOINT, {})
    mode = get_scalar_param(
        checkpoint_params, CHECKPOINT_TAG_VALIDATION, CHECKPOINT_TAG_VALIDATION_DEFAULT
    )
    mode = str(mode).upper()
    if mode not in CHECKPOINT_TAG_VALIDATION_MODES:
        raise ValueError(f"Checkpoint config contains invalid tag_validation value: {mode}")
    return mode


def get_checkpoint_config(param_dict):
    """checkpoint: storage keys for the fault-tolerant subsystem
    (runtime/checkpoint/): keep_last_k rotation, retry bounds, load-time
    verification, and the test-only fault_injection hook."""
    checkpoint_params = param_dict.get(CHECKPOINT, {})
    keep_last_k = get_scalar_param(
        checkpoint_params, CHECKPOINT_KEEP_LAST_K, CHECKPOINT_KEEP_LAST_K_DEFAULT
    )
    if keep_last_k < 0:
        raise ValueError(
            f"checkpoint.{CHECKPOINT_KEEP_LAST_K} must be >= 0 (0 keeps "
            f"everything), got {keep_last_k}"
        )
    max_retries = get_scalar_param(
        checkpoint_params, CHECKPOINT_MAX_RETRIES, CHECKPOINT_MAX_RETRIES_DEFAULT
    )
    if max_retries < 0:
        raise ValueError(
            f"checkpoint.{CHECKPOINT_MAX_RETRIES} must be >= 0, got {max_retries}"
        )
    return CheckpointConfig(
        keep_last_k=keep_last_k,
        max_retries=max_retries,
        retry_backoff_s=get_scalar_param(
            checkpoint_params, CHECKPOINT_RETRY_BACKOFF, CHECKPOINT_RETRY_BACKOFF_DEFAULT
        ),
        verify_on_load=get_scalar_param(
            checkpoint_params, CHECKPOINT_VERIFY_ON_LOAD, CHECKPOINT_VERIFY_ON_LOAD_DEFAULT
        ),
        fault_injection=checkpoint_params.get(CHECKPOINT_FAULT_INJECTION, None),
    )


def get_progressive_layer_drop(param_dict):
    pld_dict = param_dict.get(PROGRESSIVE_LAYER_DROP, {})
    enabled = get_scalar_param(pld_dict, PLD_ENABLED, PLD_ENABLED_DEFAULT)
    theta = get_scalar_param(pld_dict, PLD_THETA, PLD_THETA_DEFAULT)
    gamma = get_scalar_param(pld_dict, PLD_GAMMA, PLD_GAMMA_DEFAULT)
    return enabled, theta, gamma


def _number(params, key, default, what):
    value = get_scalar_param(params, key, default)
    if not isinstance(value, (int, float)) or isinstance(value, bool) or value < 0:
        raise ValueError(f"serving.{key} must be a number >= 0 ({what}), got {value!r}")
    return value


def _count(params, key, default, what, low=0):
    value = get_scalar_param(params, key, default)
    if value is None and default is None:
        return None
    if not isinstance(value, int) or isinstance(value, bool) or value < low:
        raise ValueError(f"serving.{key} must be an int >= {low} ({what}), got {value!r}")
    return value


def get_pipeline_config(param_dict):
    """The pipeline section over the JAX package's defaults; other keys
    (``executor``, ``partition_method``) pass through as given."""
    pipeline = {
        PIPELINE_STAGES: PIPELINE_STAGES_DEFAULT,
        PIPELINE_PARTITION: PIPELINE_PARTITION_DEFAULT,
        PIPELINE_SEED_LAYERS: PIPELINE_SEED_LAYERS_DEFAULT,
        PIPELINE_ACTIVATION_CHECKPOINT_INTERVAL: PIPELINE_ACTIVATION_CHECKPOINT_INTERVAL_DEFAULT,
        PIPELINE_NUM_MODEL_CHUNKS: PIPELINE_NUM_MODEL_CHUNKS_DEFAULT,
    }
    if PIPELINE in param_dict:
        pipeline.update(param_dict[PIPELINE])
    return pipeline


def get_sparse_attention(param_dict):
    if SPARSE_ATTENTION in param_dict:
        sparsity = param_dict[SPARSE_ATTENTION]
        mode = get_scalar_param(sparsity, SPARSE_MODE, SPARSE_MODE_DEFAULT)
        if mode == SPARSE_DENSE_MODE:
            return get_sparse_dense_config(sparsity)
        elif mode == SPARSE_FIXED_MODE:
            return get_sparse_fixed_config(sparsity)
        elif mode == SPARSE_VARIABLE_MODE:
            return get_sparse_variable_config(sparsity)
        elif mode == SPARSE_BIGBIRD_MODE:
            return get_sparse_bigbird_config(sparsity)
        elif mode == SPARSE_BSLONGFORMER_MODE:
            return get_sparse_bslongformer_config(sparsity)
        else:
            raise NotImplementedError(f"Given sparsity mode, {mode}, has not been implemented yet!")
    return None


def get_sparse_dense_config(sparsity):
    block = get_scalar_param(sparsity, SPARSE_BLOCK, SPARSE_BLOCK_DEFAULT)
    return {SPARSE_MODE: SPARSE_DENSE_MODE, SPARSE_BLOCK: block}


def get_sparse_fixed_config(sparsity):
    return {
        SPARSE_MODE: SPARSE_FIXED_MODE,
        SPARSE_BLOCK: get_scalar_param(sparsity, SPARSE_BLOCK, SPARSE_BLOCK_DEFAULT),
        SPARSE_DIFFERENT_LAYOUT_PER_HEAD: get_scalar_param(
            sparsity, SPARSE_DIFFERENT_LAYOUT_PER_HEAD, SPARSE_DIFFERENT_LAYOUT_PER_HEAD_DEFAULT
        ),
        SPARSE_NUM_LOCAL_BLOCKS: get_scalar_param(sparsity, SPARSE_NUM_LOCAL_BLOCKS, SPARSE_NUM_LOCAL_BLOCKS_DEFAULT),
        SPARSE_NUM_GLOBAL_BLOCKS: get_scalar_param(sparsity, SPARSE_NUM_GLOBAL_BLOCKS, SPARSE_NUM_GLOBAL_BLOCKS_DEFAULT),
        SPARSE_ATTENTION_TYPE: get_scalar_param(sparsity, SPARSE_ATTENTION_TYPE, SPARSE_ATTENTION_TYPE_DEFAULT),
        SPARSE_HORIZONTAL_GLOBAL_ATTENTION: get_scalar_param(
            sparsity, SPARSE_HORIZONTAL_GLOBAL_ATTENTION, SPARSE_HORIZONTAL_GLOBAL_ATTENTION_DEFAULT
        ),
        SPARSE_NUM_DIFFERENT_GLOBAL_PATTERNS: get_scalar_param(
            sparsity, SPARSE_NUM_DIFFERENT_GLOBAL_PATTERNS, SPARSE_NUM_DIFFERENT_GLOBAL_PATTERNS_DEFAULT
        ),
    }


def get_sparse_variable_config(sparsity):
    return {
        SPARSE_MODE: SPARSE_VARIABLE_MODE,
        SPARSE_BLOCK: get_scalar_param(sparsity, SPARSE_BLOCK, SPARSE_BLOCK_DEFAULT),
        SPARSE_DIFFERENT_LAYOUT_PER_HEAD: get_scalar_param(
            sparsity, SPARSE_DIFFERENT_LAYOUT_PER_HEAD, SPARSE_DIFFERENT_LAYOUT_PER_HEAD_DEFAULT
        ),
        SPARSE_NUM_RANDOM_BLOCKS: get_scalar_param(sparsity, SPARSE_NUM_RANDOM_BLOCKS, SPARSE_NUM_RANDOM_BLOCKS_DEFAULT),
        SPARSE_LOCAL_WINDOW_BLOCKS: get_scalar_param(
            sparsity, SPARSE_LOCAL_WINDOW_BLOCKS, SPARSE_LOCAL_WINDOW_BLOCKS_DEFAULT
        ),
        SPARSE_GLOBAL_BLOCK_INDICES: get_scalar_param(
            sparsity, SPARSE_GLOBAL_BLOCK_INDICES, SPARSE_GLOBAL_BLOCK_INDICES_DEFAULT
        ),
        SPARSE_GLOBAL_BLOCK_END_INDICES: get_scalar_param(
            sparsity, SPARSE_GLOBAL_BLOCK_END_INDICES, SPARSE_GLOBAL_BLOCK_END_INDICES_DEFAULT
        ),
        SPARSE_ATTENTION_TYPE: get_scalar_param(sparsity, SPARSE_ATTENTION_TYPE, SPARSE_ATTENTION_TYPE_DEFAULT),
        SPARSE_HORIZONTAL_GLOBAL_ATTENTION: get_scalar_param(
            sparsity, SPARSE_HORIZONTAL_GLOBAL_ATTENTION, SPARSE_HORIZONTAL_GLOBAL_ATTENTION_DEFAULT
        ),
    }


def get_sparse_bigbird_config(sparsity):
    return {
        SPARSE_MODE: SPARSE_BIGBIRD_MODE,
        SPARSE_BLOCK: get_scalar_param(sparsity, SPARSE_BLOCK, SPARSE_BLOCK_DEFAULT),
        SPARSE_DIFFERENT_LAYOUT_PER_HEAD: get_scalar_param(
            sparsity, SPARSE_DIFFERENT_LAYOUT_PER_HEAD, SPARSE_DIFFERENT_LAYOUT_PER_HEAD_DEFAULT
        ),
        SPARSE_NUM_RANDOM_BLOCKS: get_scalar_param(sparsity, SPARSE_NUM_RANDOM_BLOCKS, SPARSE_NUM_RANDOM_BLOCKS_DEFAULT),
        SPARSE_NUM_SLIDING_WINDOW_BLOCKS: get_scalar_param(
            sparsity, SPARSE_NUM_SLIDING_WINDOW_BLOCKS, SPARSE_NUM_SLIDING_WINDOW_BLOCKS_DEFAULT
        ),
        SPARSE_NUM_GLOBAL_BLOCKS: get_scalar_param(sparsity, SPARSE_NUM_GLOBAL_BLOCKS, SPARSE_NUM_GLOBAL_BLOCKS_DEFAULT),
    }


def get_sparse_bslongformer_config(sparsity):
    return {
        SPARSE_MODE: SPARSE_BSLONGFORMER_MODE,
        SPARSE_BLOCK: get_scalar_param(sparsity, SPARSE_BLOCK, SPARSE_BLOCK_DEFAULT),
        SPARSE_DIFFERENT_LAYOUT_PER_HEAD: get_scalar_param(
            sparsity, SPARSE_DIFFERENT_LAYOUT_PER_HEAD, SPARSE_DIFFERENT_LAYOUT_PER_HEAD_DEFAULT
        ),
        SPARSE_NUM_SLIDING_WINDOW_BLOCKS: get_scalar_param(
            sparsity, SPARSE_NUM_SLIDING_WINDOW_BLOCKS, SPARSE_NUM_SLIDING_WINDOW_BLOCKS_DEFAULT
        ),
        SPARSE_GLOBAL_BLOCK_INDICES: get_scalar_param(
            sparsity, SPARSE_GLOBAL_BLOCK_INDICES, SPARSE_GLOBAL_BLOCK_INDICES_DEFAULT
        ),
        SPARSE_GLOBAL_BLOCK_END_INDICES: get_scalar_param(
            sparsity, SPARSE_GLOBAL_BLOCK_END_INDICES, SPARSE_GLOBAL_BLOCK_END_INDICES_DEFAULT
        ),
    }


@dataclass
class ParallelConfig:
    """Typed view of the ``parallel`` block: the serving engine's
    tensor-parallel mesh shape plus optional sharding-registry rule
    overrides. The mesh itself is built by the engine
    (parallel/sharding_registry.py), never here."""

    enabled: bool = False
    mesh_shape: tuple = PARALLEL_MESH_SHAPE_DEFAULT   # (data, model)
    partition_rules: tuple = None   # ((pattern, spec-elements), ...)
    replicate_unmatched: bool = True


def get_parallel_config(param_dict):
    """parallel: mesh shape + sharding-registry rule overrides, with the JAX
    package's keys, defaults and messages. The block being present enables
    it. Validation is of shapes only: the heads' divisibility and the rank
    count are checked by the engine, which knows the model and the world."""
    section = param_dict.get(PARALLEL, None)
    params = section or {}
    enabled = bool(get_scalar_param(params, PARALLEL_ENABLED, section is not None))

    mesh_shape = get_scalar_param(params, PARALLEL_MESH_SHAPE, PARALLEL_MESH_SHAPE_DEFAULT)
    if isinstance(mesh_shape, dict):
        unknown = [k for k in mesh_shape if k not in PARALLEL_MESH_AXES]
        if unknown:
            raise ValueError(
                f"parallel.{PARALLEL_MESH_SHAPE} names unknown axes "
                f"{unknown!r}; the serving mesh defines {PARALLEL_MESH_AXES}")
        sizes = [mesh_shape.get(ax, 1) for ax in PARALLEL_MESH_AXES]
    elif isinstance(mesh_shape, (list, tuple)) and len(mesh_shape) == 2:
        sizes = list(mesh_shape)
    else:
        raise ValueError(
            f"parallel.{PARALLEL_MESH_SHAPE} must be a (data, model) pair "
            f"or a {{axis: size}} dict over {PARALLEL_MESH_AXES}, "
            f"got {mesh_shape!r}")
    for ax, size in zip(PARALLEL_MESH_AXES, sizes):
        if isinstance(size, bool) or not isinstance(size, int) or size < 1:
            raise ValueError(
                f"parallel.{PARALLEL_MESH_SHAPE} {ax!r} size must be an "
                f"int >= 1, got {size!r}")
    mesh_shape = tuple(sizes)
    # a dict that omits an axis leaves it size 1 but defined, so a rule
    # may name any axis of PARALLEL_MESH_AXES
    allowed_axes = PARALLEL_MESH_AXES

    rules = get_scalar_param(params, PARALLEL_PARTITION_RULES, PARALLEL_PARTITION_RULES_DEFAULT)
    if rules is not None:
        if not isinstance(rules, (list, tuple)):
            raise ValueError(
                f"parallel.{PARALLEL_PARTITION_RULES} must be a list of "
                f"[pattern, spec] pairs, got {rules!r}")
        norm = []
        for i, rule in enumerate(rules):
            if (not isinstance(rule, (list, tuple)) or len(rule) != 2
                    or not isinstance(rule[0], str)
                    or not isinstance(rule[1], (list, tuple))):
                raise ValueError(
                    f"parallel.{PARALLEL_PARTITION_RULES}[{i}] must be a "
                    f"[pattern, [axis-or-null, ...]] pair, got {rule!r}")
            pattern, spec = rule
            try:
                re.compile(pattern)
            except re.error as exc:
                raise ValueError(
                    f"parallel.{PARALLEL_PARTITION_RULES}[{i}] pattern "
                    f"{pattern!r} is not a valid regex: {exc}")
            elems = []
            for elem in spec:
                if elem is not None and elem not in allowed_axes:
                    raise ValueError(
                        f"parallel.{PARALLEL_PARTITION_RULES}[{i}] names "
                        f"axis {elem!r} absent from "
                        f"{PARALLEL_MESH_SHAPE}={mesh_shape} "
                        f"(axes: {allowed_axes})")
                elems.append(elem)
            norm.append((pattern, tuple(elems)))
        rules = tuple(norm)

    replicate_unmatched = get_scalar_param(params, PARALLEL_REPLICATE_UNMATCHED,
                                           PARALLEL_REPLICATE_UNMATCHED_DEFAULT)
    if not isinstance(replicate_unmatched, bool):
        raise ValueError(
            f"parallel.{PARALLEL_REPLICATE_UNMATCHED} must be a bool, "
            f"got {replicate_unmatched!r}")
    return ParallelConfig(enabled=enabled, mesh_shape=mesh_shape,
                          partition_rules=rules, replicate_unmatched=replicate_unmatched)


def get_serving_config(param_dict):
    """serving: the continuous-batching engine (inference/serving/). Present
    enables it (unless it says "enabled": false). The keys, defaults and
    checks are the JAX package's; the checks against the model (max_seq_len
    against max_position_embeddings, bucket headroom) are the engine's."""
    from deepspeed_tpu_torch.inference.serving.config import ServingConfig

    section = param_dict.get(SERVING, None)
    params = section or {}
    enabled = bool(get_scalar_param(params, SERVING_ENABLED, section is not None))
    max_slots = _count(params, SERVING_MAX_SLOTS, SERVING_MAX_SLOTS_DEFAULT,
                       "the decode batch dimension", low=1)
    max_queue = _count(params, SERVING_MAX_QUEUE, SERVING_MAX_QUEUE_DEFAULT,
                       "the admission queue", low=1)
    max_seq_len = _count(params, SERVING_MAX_SEQ_LEN, SERVING_MAX_SEQ_LEN_DEFAULT,
                         "room for a prompt token and a generated token", low=2)
    buckets = get_scalar_param(params, SERVING_PROMPT_BUCKETS, SERVING_PROMPT_BUCKETS_DEFAULT)
    if buckets is not None:
        if (not isinstance(buckets, (list, tuple)) or not buckets
                or not all(isinstance(b, int) and b >= 1 for b in buckets)
                or list(buckets) != sorted(set(buckets))):
            raise ValueError(f"serving.{SERVING_PROMPT_BUCKETS} must be a strictly "
                             f"ascending list of ints >= 1, got {buckets!r}")
        buckets = tuple(buckets)
    default_max_new = _count(params, SERVING_DEFAULT_MAX_NEW_TOKENS,
                             SERVING_DEFAULT_MAX_NEW_TOKENS_DEFAULT, "tokens", low=1)
    request_timeout_s = _number(params, SERVING_REQUEST_TIMEOUT,
                                SERVING_REQUEST_TIMEOUT_DEFAULT,
                                "0 disables per-request deadlines")
    prefill_chunk = _count(params, SERVING_PREFILL_CHUNK_TOKENS,
                           SERVING_PREFILL_CHUNK_TOKENS_DEFAULT,
                           "0 disables chunked prefill")
    prefix_cache_mb = _number(params, SERVING_PREFIX_CACHE_MB,
                              SERVING_PREFIX_CACHE_MB_DEFAULT,
                              "0 disables the prefix KV cache")
    prefix_spill_mb = _number(params, SERVING_PREFIX_SPILL_MB,
                              SERVING_PREFIX_SPILL_MB_DEFAULT,
                              "0 disables the prefix-cache spill tier")
    prefix_spill_dir = get_scalar_param(params, SERVING_PREFIX_SPILL_DIR,
                                        SERVING_PREFIX_SPILL_DIR_DEFAULT)
    if prefix_spill_dir is not None and not isinstance(prefix_spill_dir, str):
        raise ValueError(f"serving.{SERVING_PREFIX_SPILL_DIR} must be a directory path "
                         f"string or null (null disables the disk tier), got "
                         f"{prefix_spill_dir!r}")
    host_mem_watermark_mb = _number(params, SERVING_HOST_MEM_WATERMARK_MB,
                                    SERVING_HOST_MEM_WATERMARK_MB_DEFAULT,
                                    "0 disables the memory-pressure guard")
    speculative_k = _count(params, SERVING_SPECULATIVE_K, SERVING_SPECULATIVE_K_DEFAULT,
                           "0 disables speculative decoding")
    kv_cache_dtype = get_scalar_param(params, SERVING_KV_CACHE_DTYPE,
                                      SERVING_KV_CACHE_DTYPE_DEFAULT)
    if kv_cache_dtype not in SERVING_KV_CACHE_DTYPES:
        raise ValueError(f"serving.{SERVING_KV_CACHE_DTYPE} must be one of "
                         f"{SERVING_KV_CACHE_DTYPES}, got {kv_cache_dtype!r}")
    fault_injection = params.get(SERVING_FAULT_INJECTION, None)
    if fault_injection is not None and not isinstance(fault_injection, dict):
        raise ValueError(f"serving.{SERVING_FAULT_INJECTION} must be a dict of "
                         f"fault-point specs, got {type(fault_injection).__name__}")
    attention_impl = params.get(SERVING_ATTENTION_IMPL, SERVING_ATTENTION_IMPL_DEFAULT)
    if attention_impl is not None:
        if isinstance(attention_impl, str):
            if attention_impl not in SERVING_ATTENTION_IMPLS:
                raise ValueError(f"serving.{SERVING_ATTENTION_IMPL} must be one of "
                                 f"{SERVING_ATTENTION_IMPLS}, got {attention_impl!r}")
        elif isinstance(attention_impl, dict):
            # JSON object keys are strings: bucket keys arrive as "1024"
            coerced = {}
            for key, impl in attention_impl.items():
                if isinstance(key, str) and key.isdigit():
                    key = int(key)
                elif not isinstance(key, int) and key != "default":
                    raise ValueError(f"serving.{SERVING_ATTENTION_IMPL} keys must be "
                                     f"prompt buckets (ints) or 'default', got {key!r}")
                if impl not in SERVING_ATTENTION_IMPLS:
                    raise ValueError(f"serving.{SERVING_ATTENTION_IMPL}[{key!r}] must be "
                                     f"one of {SERVING_ATTENTION_IMPLS}, got {impl!r}")
                coerced[key] = impl
            attention_impl = coerced
        else:
            raise ValueError(f"serving.{SERVING_ATTENTION_IMPL} must be an impl name, a "
                             f"{{bucket: impl}} dict, or absent, got {attention_impl!r}")
    attention_kernel = get_scalar_param(params, SERVING_ATTENTION_KERNEL,
                                        SERVING_ATTENTION_KERNEL_DEFAULT)
    if attention_kernel is not None and attention_kernel not in SERVING_ATTENTION_KERNELS:
        raise ValueError(f"serving.{SERVING_ATTENTION_KERNEL} must be one of "
                         f"{SERVING_ATTENTION_KERNELS} or absent, got {attention_kernel!r}")
    kernel_interpret = get_scalar_param(params, SERVING_KERNEL_INTERPRET,
                                        SERVING_KERNEL_INTERPRET_DEFAULT)
    if kernel_interpret is not None and not isinstance(kernel_interpret, bool):
        raise ValueError(f"serving.{SERVING_KERNEL_INTERPRET} must be a bool or absent, "
                         f"got {kernel_interpret!r}")
    kv_page_tokens = _count(params, SERVING_KV_PAGE_TOKENS, SERVING_KV_PAGE_TOKENS_DEFAULT,
                            "tokens per KV page", low=1)
    kv_pool_tokens = _count(params, SERVING_KV_POOL_TOKENS, SERVING_KV_POOL_TOKENS_DEFAULT,
                            "the shared KV-pool token budget", low=1)
    return ServingConfig(
        enabled=enabled, max_slots=max_slots, max_queue=max_queue,
        max_seq_len=max_seq_len, prompt_buckets=buckets,
        default_max_new_tokens=default_max_new,
        request_timeout_s=float(request_timeout_s),
        prefill_chunk_tokens=prefill_chunk, prefix_cache_mb=float(prefix_cache_mb),
        prefix_spill_mb=float(prefix_spill_mb), prefix_spill_dir=prefix_spill_dir,
        host_mem_watermark_mb=float(host_mem_watermark_mb), speculative_k=speculative_k,
        kv_cache_dtype=kv_cache_dtype, fault_injection=fault_injection,
        attention_impl=attention_impl, attention_kernel=attention_kernel,
        kernel_interpret=kernel_interpret, kv_page_tokens=kv_page_tokens,
        kv_pool_tokens=kv_pool_tokens)


def _get_fleet_autoscale(params):
    """fleet.autoscale sub-block: the SLO-driven control loop. Opt-in
    by presence, like every fleet sub-block."""
    from deepspeed_tpu_torch.inference.serving.config import AutoscaleConfig

    section = params.get(FLEET_AUTOSCALE, None)
    if section is not None and not isinstance(section, dict):
        raise ValueError(
            f"fleet.{FLEET_AUTOSCALE} must be a dict, "
            f"got {type(section).__name__}"
        )
    sub = section or {}
    enabled = bool(get_scalar_param(sub, FLEET_AUTOSCALE_ENABLED, section is not None))
    ints = (
        (FLEET_AUTOSCALE_MIN_REPLICAS, FLEET_AUTOSCALE_MIN_REPLICAS_DEFAULT,
         1, "scale-down floor"),
        (FLEET_AUTOSCALE_MAX_REPLICAS, FLEET_AUTOSCALE_MAX_REPLICAS_DEFAULT,
         1, "scale-up ceiling"),
        (FLEET_AUTOSCALE_WARM_SPARES, FLEET_AUTOSCALE_WARM_SPARES_DEFAULT,
         0, "pre-spawned replicas kept out of rotation"),
    )
    ivals = {}
    for key, default, floor, what in ints:
        v = get_scalar_param(sub, key, default)
        if not isinstance(v, int) or isinstance(v, bool) or v < floor:
            raise ValueError(
                f"fleet.{FLEET_AUTOSCALE}.{key} must be an int >= {floor} "
                f"({what}), got {v!r}"
            )
        ivals[key] = v
    if ivals[FLEET_AUTOSCALE_MIN_REPLICAS] > ivals[FLEET_AUTOSCALE_MAX_REPLICAS]:
        raise ValueError(
            f"fleet.{FLEET_AUTOSCALE}.{FLEET_AUTOSCALE_MIN_REPLICAS}="
            f"{ivals[FLEET_AUTOSCALE_MIN_REPLICAS]} must not exceed "
            f"{FLEET_AUTOSCALE_MAX_REPLICAS}="
            f"{ivals[FLEET_AUTOSCALE_MAX_REPLICAS]}"
        )
    numbers = (
        (FLEET_AUTOSCALE_UP_AFTER, FLEET_AUTOSCALE_UP_AFTER_DEFAULT,
         "sustained-alert window before scale-up"),
        (FLEET_AUTOSCALE_DOWN_AFTER, FLEET_AUTOSCALE_DOWN_AFTER_DEFAULT,
         "alert-quiet window before scale-down"),
        (FLEET_AUTOSCALE_COOLDOWN, FLEET_AUTOSCALE_COOLDOWN_DEFAULT,
         "minimum gap between scaling actions"),
        (FLEET_AUTOSCALE_POLL_INTERVAL, FLEET_AUTOSCALE_POLL_INTERVAL_DEFAULT,
         "control-loop tick interval"),
    )
    fvals = {}
    for key, default, what in numbers:
        v = get_scalar_param(sub, key, default)
        if not isinstance(v, (int, float)) or isinstance(v, bool) or v < 0:
            raise ValueError(
                f"fleet.{FLEET_AUTOSCALE}.{key} must be a number >= 0 "
                f"({what}), got {v!r}"
            )
        fvals[key] = float(v)
    return AutoscaleConfig(
        enabled=enabled,
        min_replicas=ivals[FLEET_AUTOSCALE_MIN_REPLICAS],
        max_replicas=ivals[FLEET_AUTOSCALE_MAX_REPLICAS],
        warm_spares=ivals[FLEET_AUTOSCALE_WARM_SPARES],
        up_after_s=fvals[FLEET_AUTOSCALE_UP_AFTER],
        down_after_s=fvals[FLEET_AUTOSCALE_DOWN_AFTER],
        cooldown_s=fvals[FLEET_AUTOSCALE_COOLDOWN],
        poll_interval_s=fvals[FLEET_AUTOSCALE_POLL_INTERVAL],
    )


def _get_fleet_degrade(params):
    """fleet.degrade sub-block: the degraded-mode ladder."""
    from deepspeed_tpu_torch.inference.serving.config import DegradeConfig

    section = params.get(FLEET_DEGRADE, None)
    if section is not None and not isinstance(section, dict):
        raise ValueError(
            f"fleet.{FLEET_DEGRADE} must be a dict, "
            f"got {type(section).__name__}"
        )
    sub = section or {}
    enabled = bool(get_scalar_param(sub, FLEET_DEGRADE_ENABLED, section is not None))
    numbers = (
        (FLEET_DEGRADE_ESCALATE_AFTER, FLEET_DEGRADE_ESCALATE_AFTER_DEFAULT,
         "sustained pressure before climbing one rung"),
        (FLEET_DEGRADE_RECOVER_AFTER, FLEET_DEGRADE_RECOVER_AFTER_DEFAULT,
         "sustained quiet before descending one rung"),
    )
    fvals = {}
    for key, default, what in numbers:
        v = get_scalar_param(sub, key, default)
        if not isinstance(v, (int, float)) or isinstance(v, bool) or v < 0:
            raise ValueError(
                f"fleet.{FLEET_DEGRADE}.{key} must be a number >= 0 "
                f"({what}), got {v!r}"
            )
        fvals[key] = float(v)
    frac = get_scalar_param(sub, FLEET_DEGRADE_PRESSURE_QUEUE_FRAC,
                            FLEET_DEGRADE_PRESSURE_QUEUE_FRAC_DEFAULT)
    if not isinstance(frac, (int, float)) or isinstance(frac, bool) \
            or not 0 < frac <= 1:
        raise ValueError(
            f"fleet.{FLEET_DEGRADE}.{FLEET_DEGRADE_PRESSURE_QUEUE_FRAC} "
            f"must be a number in (0, 1] (queue-depth fraction that counts "
            f"as pressure), got {frac!r}"
        )
    shed = sub.get(FLEET_DEGRADE_SHED_CLASSES,
                   FLEET_DEGRADE_SHED_CLASSES_DEFAULT)
    if not isinstance(shed, (list, tuple)) or any(
            not isinstance(c, str) or not c for c in shed):
        raise ValueError(
            f"fleet.{FLEET_DEGRADE}.{FLEET_DEGRADE_SHED_CLASSES} must be a "
            f"list of request-class names (empty = every class except "
            f"'default'), got {shed!r}"
        )
    return DegradeConfig(
        enabled=enabled,
        escalate_after_s=fvals[FLEET_DEGRADE_ESCALATE_AFTER],
        recover_after_s=fvals[FLEET_DEGRADE_RECOVER_AFTER],
        pressure_queue_frac=float(frac),
        shed_classes=tuple(shed),
    )


def _get_fleet_breaker(params):
    """fleet.breaker sub-block: per-replica crash-loop circuit breakers."""
    from deepspeed_tpu_torch.inference.serving.config import BreakerConfig

    section = params.get(FLEET_BREAKER, None)
    if section is not None and not isinstance(section, dict):
        raise ValueError(
            f"fleet.{FLEET_BREAKER} must be a dict, "
            f"got {type(section).__name__}"
        )
    sub = section or {}
    enabled = bool(get_scalar_param(sub, FLEET_BREAKER_ENABLED, section is not None))
    threshold = get_scalar_param(sub, FLEET_BREAKER_THRESHOLD,
                                 FLEET_BREAKER_THRESHOLD_DEFAULT)
    if not isinstance(threshold, int) or isinstance(threshold, bool) \
            or threshold < 1:
        raise ValueError(
            f"fleet.{FLEET_BREAKER}.{FLEET_BREAKER_THRESHOLD} must be an "
            f"int >= 1 (failure exits in the window that open the "
            f"breaker), got {threshold!r}"
        )
    numbers = (
        (FLEET_BREAKER_WINDOW, FLEET_BREAKER_WINDOW_DEFAULT,
         "sliding failure-count window"),
        (FLEET_BREAKER_COOLDOWN, FLEET_BREAKER_COOLDOWN_DEFAULT,
         "quarantine before the half-open probe restart"),
    )
    fvals = {}
    for key, default, what in numbers:
        v = get_scalar_param(sub, key, default)
        if not isinstance(v, (int, float)) or isinstance(v, bool) or v < 0:
            raise ValueError(
                f"fleet.{FLEET_BREAKER}.{key} must be a number >= 0 "
                f"({what}), got {v!r}"
            )
        fvals[key] = float(v)
    return BreakerConfig(
        enabled=enabled,
        threshold=threshold,
        window_s=fvals[FLEET_BREAKER_WINDOW],
        cooldown_s=fvals[FLEET_BREAKER_COOLDOWN],
    )


def _get_fleet_rollout(params):
    """fleet.rollout sub-block: zero-downtime weight rollout."""
    from deepspeed_tpu_torch.inference.serving.config import RolloutConfig

    section = params.get(FLEET_ROLLOUT, None)
    if section is not None and not isinstance(section, dict):
        raise ValueError(
            f"fleet.{FLEET_ROLLOUT} must be a dict, "
            f"got {type(section).__name__}"
        )
    sub = section or {}
    enabled = bool(get_scalar_param(sub, FLEET_ROLLOUT_ENABLED, section is not None))
    fractions = (
        (FLEET_ROLLOUT_CANARY_FRACTION, FLEET_ROLLOUT_CANARY_FRACTION_DEFAULT,
         "traffic slice routed to the canary generation"),
        (FLEET_ROLLOUT_SHADOW_SAMPLE_RATE,
         FLEET_ROLLOUT_SHADOW_SAMPLE_RATE_DEFAULT,
         "completed-request fraction replayed as shadow traffic"),
        (FLEET_ROLLOUT_SHADOW_DIFF_THRESHOLD,
         FLEET_ROLLOUT_SHADOW_DIFF_THRESHOLD_DEFAULT,
         "shadow diff rate above which the canary rolls back"),
    )
    fracs = {}
    for key, default, what in fractions:
        v = get_scalar_param(sub, key, default)
        if not isinstance(v, (int, float)) or isinstance(v, bool) \
                or not 0 <= v <= 1:
            raise ValueError(
                f"fleet.{FLEET_ROLLOUT}.{key} must be a number in [0, 1] "
                f"({what}), got {v!r}"
            )
        fracs[key] = float(v)
    ints = (
        (FLEET_ROLLOUT_CANARY_REPLICAS, FLEET_ROLLOUT_CANARY_REPLICAS_DEFAULT,
         1, "replicas booted on the new weights for the canary"),
        (FLEET_ROLLOUT_SHADOW_MAX_PENDING,
         FLEET_ROLLOUT_SHADOW_MAX_PENDING_DEFAULT, 1,
         "bounded shadow backlog"),
        (FLEET_ROLLOUT_MIN_CANARY_REQUESTS,
         FLEET_ROLLOUT_MIN_CANARY_REQUESTS_DEFAULT, 0,
         "canary-routed attempts required before promotion"),
        (FLEET_ROLLOUT_MIN_SHADOW_COMPARED,
         FLEET_ROLLOUT_MIN_SHADOW_COMPARED_DEFAULT, 0,
         "shadow compares required before promotion"),
        (FLEET_ROLLOUT_MAX_CANARY_CRASHES,
         FLEET_ROLLOUT_MAX_CANARY_CRASHES_DEFAULT, 0,
         "canary process deaths that trigger rollback"),
    )
    ivals = {}
    for key, default, lo, what in ints:
        v = get_scalar_param(sub, key, default)
        if not isinstance(v, int) or isinstance(v, bool) or v < lo:
            raise ValueError(
                f"fleet.{FLEET_ROLLOUT}.{key} must be an int >= {lo} "
                f"({what}), got {v!r}"
            )
        ivals[key] = v
    numbers = (
        (FLEET_ROLLOUT_CANARY_HOLD, FLEET_ROLLOUT_CANARY_HOLD_DEFAULT,
         "minimum canary soak before promotion"),
        (FLEET_ROLLOUT_POLL_INTERVAL, FLEET_ROLLOUT_POLL_INTERVAL_DEFAULT,
         "manifest poll cadence"),
        (FLEET_ROLLOUT_RECOVERY_BOUND, FLEET_ROLLOUT_RECOVERY_BOUND_DEFAULT,
         "rollback recovery deadline"),
    )
    fvals = {}
    for key, default, what in numbers:
        v = get_scalar_param(sub, key, default)
        if not isinstance(v, (int, float)) or isinstance(v, bool) or v < 0:
            raise ValueError(
                f"fleet.{FLEET_ROLLOUT}.{key} must be a number >= 0 "
                f"({what}), got {v!r}"
            )
        fvals[key] = float(v)
    rollback_on = sub.get(FLEET_ROLLOUT_ROLLBACK_ON,
                          FLEET_ROLLOUT_ROLLBACK_ON_DEFAULT)
    valid = set(FLEET_ROLLOUT_ROLLBACK_ON_DEFAULT)
    if not isinstance(rollback_on, (list, tuple)) or any(
            trigger not in valid for trigger in rollback_on):
        raise ValueError(
            f"fleet.{FLEET_ROLLOUT}.{FLEET_ROLLOUT_ROLLBACK_ON} must be a "
            f"list drawn from {sorted(valid)}, got {rollback_on!r}"
        )
    return RolloutConfig(
        enabled=enabled,
        canary_fraction=fracs[FLEET_ROLLOUT_CANARY_FRACTION],
        canary_replicas=ivals[FLEET_ROLLOUT_CANARY_REPLICAS],
        shadow_sample_rate=fracs[FLEET_ROLLOUT_SHADOW_SAMPLE_RATE],
        shadow_max_pending=ivals[FLEET_ROLLOUT_SHADOW_MAX_PENDING],
        canary_hold_s=fvals[FLEET_ROLLOUT_CANARY_HOLD],
        min_canary_requests=ivals[FLEET_ROLLOUT_MIN_CANARY_REQUESTS],
        min_shadow_compared=ivals[FLEET_ROLLOUT_MIN_SHADOW_COMPARED],
        shadow_diff_threshold=fracs[FLEET_ROLLOUT_SHADOW_DIFF_THRESHOLD],
        max_canary_crashes=ivals[FLEET_ROLLOUT_MAX_CANARY_CRASHES],
        rollback_on=tuple(rollback_on),
        poll_interval_s=fvals[FLEET_ROLLOUT_POLL_INTERVAL],
        recovery_bound_s=fvals[FLEET_ROLLOUT_RECOVERY_BOUND],
    )


def _get_fleet_roles(params):
    """fleet.roles sub-block: disaggregated prefill/decode role pools."""
    from deepspeed_tpu_torch.inference.serving.config import RolesConfig

    section = params.get(FLEET_ROLES, None)
    if section is not None and not isinstance(section, dict):
        raise ValueError(
            f"fleet.{FLEET_ROLES} must be a dict, "
            f"got {type(section).__name__}"
        )
    sub = section or {}
    enabled = bool(get_scalar_param(sub, FLEET_ROLES_ENABLED, section is not None))
    ints = (
        (FLEET_ROLES_PREFILL_REPLICAS, FLEET_ROLES_PREFILL_REPLICAS_DEFAULT,
         "replicas booted into the prefill pool"),
        (FLEET_ROLES_DECODE_REPLICAS, FLEET_ROLES_DECODE_REPLICAS_DEFAULT,
         "replicas booted into the decode pool"),
        (FLEET_ROLES_MAX_PREFILL_REPLICAS,
         FLEET_ROLES_MAX_PREFILL_REPLICAS_DEFAULT,
         "autoscaler ceiling for the prefill pool"),
        (FLEET_ROLES_MAX_DECODE_REPLICAS,
         FLEET_ROLES_MAX_DECODE_REPLICAS_DEFAULT,
         "autoscaler ceiling for the decode pool"),
    )
    ivals = {}
    for key, default, what in ints:
        v = get_scalar_param(sub, key, default)
        if not isinstance(v, int) or isinstance(v, bool) or v < 1:
            raise ValueError(
                f"fleet.{FLEET_ROLES}.{key} must be an int >= 1 "
                f"({what}), got {v!r}"
            )
        ivals[key] = v
    for key, floor_key in (
            (FLEET_ROLES_MAX_PREFILL_REPLICAS, FLEET_ROLES_PREFILL_REPLICAS),
            (FLEET_ROLES_MAX_DECODE_REPLICAS, FLEET_ROLES_DECODE_REPLICAS)):
        if ivals[key] < ivals[floor_key]:
            raise ValueError(
                f"fleet.{FLEET_ROLES}.{key} must be >= "
                f"fleet.{FLEET_ROLES}.{floor_key} "
                f"({ivals[key]} < {ivals[floor_key]})"
            )
    return RolesConfig(
        enabled=enabled,
        prefill_replicas=ivals[FLEET_ROLES_PREFILL_REPLICAS],
        decode_replicas=ivals[FLEET_ROLES_DECODE_REPLICAS],
        max_prefill_replicas=ivals[FLEET_ROLES_MAX_PREFILL_REPLICAS],
        max_decode_replicas=ivals[FLEET_ROLES_MAX_DECODE_REPLICAS],
    )


def _get_fleet_handoff(params):
    """fleet.handoff sub-block: crash-safe KV-page transfer."""
    from deepspeed_tpu_torch.inference.serving.config import HandoffConfig

    section = params.get(FLEET_HANDOFF, None)
    if section is not None and not isinstance(section, dict):
        raise ValueError(
            f"fleet.{FLEET_HANDOFF} must be a dict, "
            f"got {type(section).__name__}"
        )
    sub = section or {}
    enabled = bool(get_scalar_param(sub, FLEET_HANDOFF_ENABLED, section is not None))
    max_frame = get_scalar_param(sub, FLEET_HANDOFF_MAX_FRAME_BYTES,
                                 FLEET_HANDOFF_MAX_FRAME_BYTES_DEFAULT)
    if not isinstance(max_frame, int) or isinstance(max_frame, bool) \
            or max_frame < 1:
        raise ValueError(
            f"fleet.{FLEET_HANDOFF}.{FLEET_HANDOFF_MAX_FRAME_BYTES} must be "
            f"an int >= 1 (binary page-frame size cap), got {max_frame!r}"
        )
    retries = get_scalar_param(sub, FLEET_HANDOFF_RETRIES,
                               FLEET_HANDOFF_RETRIES_DEFAULT)
    if not isinstance(retries, int) or isinstance(retries, bool) or retries < 1:
        raise ValueError(
            f"fleet.{FLEET_HANDOFF}.{FLEET_HANDOFF_RETRIES} must be an "
            f"int >= 1 (total transfer attempts), got {retries!r}"
        )
    numbers = (
        (FLEET_HANDOFF_ATTEMPT_TIMEOUT, FLEET_HANDOFF_ATTEMPT_TIMEOUT_DEFAULT,
         "per-attempt socket deadline"),
        (FLEET_HANDOFF_BACKOFF, FLEET_HANDOFF_BACKOFF_DEFAULT,
         "base retry backoff"),
        (FLEET_HANDOFF_BACKOFF_MAX, FLEET_HANDOFF_BACKOFF_MAX_DEFAULT,
         "retry backoff cap"),
        (FLEET_HANDOFF_CLAIM_TTL, FLEET_HANDOFF_CLAIM_TTL_DEFAULT,
         "orphaned claim reap deadline"),
        (FLEET_HANDOFF_RESUME_TTL, FLEET_HANDOFF_RESUME_TTL_DEFAULT,
         "installed-but-unresumed reap deadline"),
    )
    fvals = {}
    for key, default, what in numbers:
        v = get_scalar_param(sub, key, default)
        if not isinstance(v, (int, float)) or isinstance(v, bool) or v < 0:
            raise ValueError(
                f"fleet.{FLEET_HANDOFF}.{key} must be a number >= 0 "
                f"({what}), got {v!r}"
            )
        fvals[key] = float(v)
    return HandoffConfig(
        enabled=enabled,
        max_frame_bytes=max_frame,
        attempt_timeout_s=fvals[FLEET_HANDOFF_ATTEMPT_TIMEOUT],
        retries=retries,
        backoff_s=fvals[FLEET_HANDOFF_BACKOFF],
        backoff_max_s=fvals[FLEET_HANDOFF_BACKOFF_MAX],
        claim_ttl_s=fvals[FLEET_HANDOFF_CLAIM_TTL],
        resume_ttl_s=fvals[FLEET_HANDOFF_RESUME_TTL],
    )


def get_fleet_config(param_dict):
    """fleet: routing front-door over N serving replicas
    (inference/serving/router.py, replica.py). Opt-in like the serving
    block: present enables (unless it sets "enabled": false); absent
    means no fleet policy is built. Shape-only validation — endpoint
    health and routability are runtime concerns of the Router."""
    from deepspeed_tpu_torch.inference.serving.config import FleetConfig

    section = param_dict.get(FLEET, None)
    params = section or {}
    enabled = bool(get_scalar_param(params, FLEET_ENABLED, section is not None))
    replicas = get_scalar_param(params, FLEET_REPLICAS, FLEET_REPLICAS_DEFAULT)
    if not isinstance(replicas, int) or isinstance(replicas, bool) or replicas < 1:
        raise ValueError(
            f"fleet.{FLEET_REPLICAS} must be an int >= 1, got {replicas!r}"
        )
    retry_budget = get_scalar_param(
        params, FLEET_RETRY_BUDGET, FLEET_RETRY_BUDGET_DEFAULT
    )
    if not isinstance(retry_budget, int) or isinstance(retry_budget, bool) \
            or retry_budget < 0:
        raise ValueError(
            f"fleet.{FLEET_RETRY_BUDGET} must be an int >= 0 (failure "
            f"re-routes per request; 0 = fail on first death), "
            f"got {retry_budget!r}"
        )
    numbers = (
        (FLEET_RETRY_BACKOFF, FLEET_RETRY_BACKOFF_DEFAULT,
         "base failure-retry backoff"),
        (FLEET_RETRY_BACKOFF_MAX, FLEET_RETRY_BACKOFF_MAX_DEFAULT,
         "failure-retry backoff cap"),
        (FLEET_ATTEMPT_TIMEOUT, FLEET_ATTEMPT_TIMEOUT_DEFAULT,
         "per-attempt socket deadline (0 = unbounded)"),
        (FLEET_DRAIN_TIMEOUT, FLEET_DRAIN_TIMEOUT_DEFAULT,
         "replica drain deadline on SIGTERM"),
        (FLEET_HEALTH_TTL, FLEET_HEALTH_TTL_DEFAULT,
         "health probe cache TTL"),
        (FLEET_SHED_RETRY_AFTER, FLEET_SHED_RETRY_AFTER_DEFAULT,
         "retry-after hint on shed"),
    )
    vals = {}
    for key, default, what in numbers:
        v = get_scalar_param(params, key, default)
        if not isinstance(v, (int, float)) or isinstance(v, bool) or v < 0:
            raise ValueError(
                f"fleet.{key} must be a number >= 0 ({what}), got {v!r}"
            )
        vals[key] = float(v)
    affinity = get_scalar_param(
        params, FLEET_AFFINITY_PREFIX_TOKENS,
        FLEET_AFFINITY_PREFIX_TOKENS_DEFAULT
    )
    if not isinstance(affinity, int) or isinstance(affinity, bool) or affinity < 0:
        raise ValueError(
            f"fleet.{FLEET_AFFINITY_PREFIX_TOKENS} must be an int >= 0 "
            f"(0 disables prefix affinity), got {affinity!r}"
        )
    saturation = get_scalar_param(
        params, FLEET_SATURATION_QUEUE_DEPTH,
        FLEET_SATURATION_QUEUE_DEPTH_DEFAULT
    )
    if not isinstance(saturation, int) or isinstance(saturation, bool) \
            or saturation < 1:
        raise ValueError(
            f"fleet.{FLEET_SATURATION_QUEUE_DEPTH} must be an int >= 1, "
            f"got {saturation!r}"
        )
    inflight = params.get(FLEET_MAX_INFLIGHT_TOKENS,
                          FLEET_MAX_INFLIGHT_TOKENS_DEFAULT)
    if isinstance(inflight, dict):
        for cls, budget in inflight.items():
            if not isinstance(cls, str) or not isinstance(budget, int) \
                    or isinstance(budget, bool) or budget < 0:
                raise ValueError(
                    f"fleet.{FLEET_MAX_INFLIGHT_TOKENS}[{cls!r}] must map a "
                    f"request-class name to an int >= 0 token budget "
                    f"(0 = unbounded), got {budget!r}"
                )
    elif not isinstance(inflight, int) or isinstance(inflight, bool) \
            or inflight < 0:
        raise ValueError(
            f"fleet.{FLEET_MAX_INFLIGHT_TOKENS} must be an int >= 0 or a "
            f"{{class: budget}} dict (0 = unbounded), got {inflight!r}"
        )
    return FleetConfig(
        enabled=enabled,
        replicas=replicas,
        retry_budget=retry_budget,
        retry_backoff_s=vals[FLEET_RETRY_BACKOFF],
        retry_backoff_max_s=vals[FLEET_RETRY_BACKOFF_MAX],
        attempt_timeout_s=vals[FLEET_ATTEMPT_TIMEOUT],
        drain_timeout_s=vals[FLEET_DRAIN_TIMEOUT],
        health_ttl_s=vals[FLEET_HEALTH_TTL],
        affinity_prefix_tokens=affinity,
        saturation_queue_depth=saturation,
        max_inflight_tokens=inflight,
        shed_retry_after_s=vals[FLEET_SHED_RETRY_AFTER],
        autoscale=_get_fleet_autoscale(params),
        degrade=_get_fleet_degrade(params),
        breaker=_get_fleet_breaker(params),
        rollout=_get_fleet_rollout(params),
        roles=_get_fleet_roles(params),
        handoff=_get_fleet_handoff(params),
    )


def get_resilience_config(param_dict):
    """resilience: step-level divergence guard / watchdog / auto-rollback
    recovery and the job-level keys (runtime/resilience/), with the JAX
    package's keys, defaults and refusals. The block being present enables
    the subsystem (unless it sets "enabled": false); absent means disabled
    and the engine's train_batch path is untouched."""
    section = param_dict.get(RESILIENCE, None)
    params = section or {}
    enabled = bool(get_scalar_param(params, RESILIENCE_ENABLED, section is not None))
    spike_window = get_scalar_param(
        params, RESILIENCE_SPIKE_WINDOW, RESILIENCE_SPIKE_WINDOW_DEFAULT
    )
    if not isinstance(spike_window, int) or spike_window < 0:
        raise ValueError(
            f"resilience.{RESILIENCE_SPIKE_WINDOW} must be an int >= 0 "
            f"(0 disables spike detection), got {spike_window!r}"
        )
    spike_threshold = get_scalar_param(
        params, RESILIENCE_SPIKE_THRESHOLD, RESILIENCE_SPIKE_THRESHOLD_DEFAULT
    )
    if not spike_threshold > 1.0:
        raise ValueError(
            f"resilience.{RESILIENCE_SPIKE_THRESHOLD} must be > 1.0 (a multiple "
            f"of the rolling median), got {spike_threshold!r}"
        )
    max_recoveries = get_scalar_param(
        params, RESILIENCE_MAX_RECOVERIES, RESILIENCE_MAX_RECOVERIES_DEFAULT
    )
    if not isinstance(max_recoveries, int) or max_recoveries < 0:
        raise ValueError(
            f"resilience.{RESILIENCE_MAX_RECOVERIES} must be an int >= 0, "
            f"got {max_recoveries!r}"
        )
    recovery_backoff_s = get_scalar_param(
        params, RESILIENCE_RECOVERY_BACKOFF, RESILIENCE_RECOVERY_BACKOFF_DEFAULT
    )
    if recovery_backoff_s < 0:
        raise ValueError(
            f"resilience.{RESILIENCE_RECOVERY_BACKOFF} must be >= 0, "
            f"got {recovery_backoff_s!r}"
        )
    step_timeout_s = get_scalar_param(
        params, RESILIENCE_STEP_TIMEOUT, RESILIENCE_STEP_TIMEOUT_DEFAULT
    )
    if step_timeout_s < 0:
        raise ValueError(
            f"resilience.{RESILIENCE_STEP_TIMEOUT} must be >= 0 "
            f"(0 disables the watchdog), got {step_timeout_s!r}"
        )
    fault_injection = params.get(RESILIENCE_FAULT_INJECTION, None)
    if fault_injection is not None and not isinstance(fault_injection, dict):
        raise ValueError(
            f"resilience.{RESILIENCE_FAULT_INJECTION} must be a dict of "
            f"fault-point specs, got {type(fault_injection).__name__}"
        )
    peer_timeout_s = get_scalar_param(
        params, RESILIENCE_PEER_TIMEOUT, RESILIENCE_PEER_TIMEOUT_DEFAULT
    )
    if peer_timeout_s < 0:
        raise ValueError(
            f"resilience.{RESILIENCE_PEER_TIMEOUT} must be >= 0 "
            f"(0 disables health gossip), got {peer_timeout_s!r}"
        )
    comm_timeout_s = get_scalar_param(
        params, RESILIENCE_COMM_TIMEOUT, RESILIENCE_COMM_TIMEOUT_DEFAULT
    )
    if comm_timeout_s < 0:
        raise ValueError(
            f"resilience.{RESILIENCE_COMM_TIMEOUT} must be >= 0 "
            f"(0 leaves host collectives unbounded), got {comm_timeout_s!r}"
        )
    gossip_dir = get_scalar_param(
        params, RESILIENCE_GOSSIP_DIR, RESILIENCE_GOSSIP_DIR_DEFAULT
    )
    if gossip_dir is not None and not isinstance(gossip_dir, str):
        raise ValueError(
            f"resilience.{RESILIENCE_GOSSIP_DIR} must be a path string, "
            f"got {type(gossip_dir).__name__}"
        )
    preemption_save_dir = get_scalar_param(
        params, RESILIENCE_PREEMPTION_SAVE_DIR, RESILIENCE_PREEMPTION_SAVE_DIR_DEFAULT
    )
    if preemption_save_dir is not None and not isinstance(preemption_save_dir, str):
        raise ValueError(
            f"resilience.{RESILIENCE_PREEMPTION_SAVE_DIR} must be a path "
            f"string, got {type(preemption_save_dir).__name__}"
        )
    return ResilienceConfig(
        enabled=enabled,
        divergence_check=bool(get_scalar_param(
            params, RESILIENCE_DIVERGENCE_CHECK, RESILIENCE_DIVERGENCE_CHECK_DEFAULT
        )),
        spike_window=spike_window,
        spike_threshold=float(spike_threshold),
        max_recoveries=max_recoveries,
        recovery_backoff_s=float(recovery_backoff_s),
        skip_poisoned_batches=bool(get_scalar_param(
            params, RESILIENCE_SKIP_POISONED_BATCHES, RESILIENCE_SKIP_POISONED_BATCHES_DEFAULT
        )),
        step_timeout_s=float(step_timeout_s),
        fault_injection=fault_injection,
        handle_preemption=bool(get_scalar_param(
            params, RESILIENCE_HANDLE_PREEMPTION, RESILIENCE_HANDLE_PREEMPTION_DEFAULT
        )),
        preemption_save_dir=preemption_save_dir,
        gossip_dir=gossip_dir,
        peer_timeout_s=float(peer_timeout_s),
        comm_timeout_s=float(comm_timeout_s),
    )


def _world_size():
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_world_size()
    return 1


class DeepSpeedConfig:
    def __init__(self, json_file_or_dict, mpu=None, param_dict=None, world_size=None):
        if param_dict is None:
            if isinstance(json_file_or_dict, dict):
                self._param_dict = json_file_or_dict
            else:
                if not os.path.exists(json_file_or_dict):
                    raise DeepSpeedConfigError(
                        f"DeepSpeed config file not found: {json_file_or_dict}")
                with open(json_file_or_dict, "r") as f:
                    self._param_dict = json.load(
                        f, object_pairs_hook=dict_raise_error_on_duplicate_keys)
        else:
            self._param_dict = param_dict

        if world_size is not None:
            self.world_size = world_size
        elif mpu is not None:
            self.world_size = mpu.get_data_parallel_world_size()
        else:
            self.world_size = _world_size()

        # elasticity may override the batch parameters before inference runs
        self.elasticity_enabled = False
        self._configure_elasticity()

        self._initialize_params(self._param_dict)
        self._configure_train_batch_size()
        self._do_error_check()
        self._check_ported(self._param_dict)

    def _configure_elasticity(self):
        if not elasticity_enabled(self._param_dict):
            return

        elastic_dict = self._param_dict[ELASTICITY]
        ensure_immutable_elastic_config(runtime_elastic_config_dict=elastic_dict)

        self.elastic_model_parallel_size = elastic_dict.get("model_parallel_size", 1)
        self.num_gpus_per_node = elastic_dict.get("num_gpus_per_node", 1)

        ignore_non_elastic_batch_info = elastic_dict.get(
            IGNORE_NON_ELASTIC_BATCH_INFO, IGNORE_NON_ELASTIC_BATCH_INFO_DEFAULT
        )
        if not ignore_non_elastic_batch_info:
            batch_params = [TRAIN_BATCH_SIZE, TRAIN_MICRO_BATCH_SIZE_PER_GPU,
                            GRADIENT_ACCUMULATION_STEPS]
            if any(p in self._param_dict for p in batch_params):
                raise ElasticityConfigError(
                    "One or more batch related parameters were found in your ds_config "
                    f"({TRAIN_BATCH_SIZE}, {TRAIN_MICRO_BATCH_SIZE_PER_GPU}, and/or "
                    f"{GRADIENT_ACCUMULATION_STEPS}). These parameters *will not be used* "
                    "since elastic training is enabled, which takes control of these "
                    "parameters. If you want to suppress this error (the parameters will "
                    "be silently ignored) please set "
                    f'"{IGNORE_NON_ELASTIC_BATCH_INFO}":true in your elasticity config.'
                )

        final_batch_size, valid_gpus, micro_batch_size = compute_elastic_config(
            ds_config=self._param_dict, target_deepspeed_version=__version__,
            world_size=self.world_size
        )
        self.elastic_valid_gpus = valid_gpus

        self._param_dict[TRAIN_BATCH_SIZE] = final_batch_size
        self._param_dict[TRAIN_MICRO_BATCH_SIZE_PER_GPU] = micro_batch_size
        self._param_dict[GRADIENT_ACCUMULATION_STEPS] = \
            final_batch_size // (micro_batch_size * self.world_size)
        self.elasticity_enabled = True

    def _initialize_params(self, param_dict):
        self.train_batch_size = get_scalar_param(param_dict, TRAIN_BATCH_SIZE, None)
        self.train_micro_batch_size_per_gpu = get_scalar_param(
            param_dict, TRAIN_MICRO_BATCH_SIZE_PER_GPU, None)
        self.gradient_accumulation_steps = get_scalar_param(
            param_dict, GRADIENT_ACCUMULATION_STEPS, None)
        self.steps_per_print = get_scalar_param(param_dict, STEPS_PER_PRINT,
                                                STEPS_PER_PRINT_DEFAULT)
        self.seed = get_scalar_param(param_dict, SEED, SEED_DEFAULT)
        self.dump_state = get_scalar_param(param_dict, DUMP_STATE, DUMP_STATE_DEFAULT)
        self.disable_allgather = get_scalar_param(param_dict, DISABLE_ALLGATHER,
                                                  DISABLE_ALLGATHER_DEFAULT)
        self.allreduce_always_fp32 = get_scalar_param(param_dict, ALLREDUCE_ALWAYS_FP32,
                                                      ALLREDUCE_ALWAYS_FP32_DEFAULT)
        self.wall_clock_breakdown = get_wall_clock_breakdown(param_dict)
        self.memory_breakdown = get_memory_breakdown(param_dict)
        self.tensorboard_enabled = get_tensorboard_enabled(param_dict)
        self.tensorboard_output_path = get_tensorboard_output_path(param_dict)
        self.tensorboard_job_name = get_tensorboard_job_name(param_dict)
        (self.csv_monitor_enabled, self.csv_monitor_output_path,
         self.csv_monitor_job_name) = get_csv_monitor(param_dict)
        self.prescale_gradients = get_scalar_param(param_dict, PRESCALE_GRADIENTS,
                                                   PRESCALE_GRADIENTS_DEFAULT)
        self.gradient_predivide_factor = get_scalar_param(
            param_dict, GRADIENT_PREDIVIDE_FACTOR, GRADIENT_PREDIVIDE_FACTOR_DEFAULT)

        self.zero_allow_untested_optimizer = get_scalar_param(
            param_dict, ZERO_ALLOW_UNTESTED_OPTIMIZER, ZERO_ALLOW_UNTESTED_OPTIMIZER_DEFAULT)
        self.zero_config = DeepSpeedZeroConfig(param_dict)
        self.zero_optimization_stage = self.zero_config.stage
        self.zero_enabled = self.zero_optimization_stage > ZERO_OPTIMIZATION_DISABLED
        self.activation_checkpointing_config = DeepSpeedActivationCheckpointingConfig(
            param_dict)
        self.flops_profiler_config = DeepSpeedFlopsProfilerConfig(param_dict)
        self.sentinel_config = DeepSpeedSentinelConfig(param_dict)

        self.fp16_enabled = get_fp16_enabled(param_dict)
        self.bfloat16_enabled = get_bfloat16_enabled(param_dict)
        self.amp_enabled = get_amp_enabled(param_dict)
        self.amp_params = get_amp_params(param_dict)
        self.loss_scale = get_loss_scale(param_dict)
        self.initial_dynamic_scale = get_initial_dynamic_scale(param_dict)
        self.dynamic_loss_scale_args = get_dynamic_loss_scale_args(param_dict)
        self.gradient_clipping = get_scalar_param(param_dict, GRADIENT_CLIPPING,
                                                  GRADIENT_CLIPPING_DEFAULT)

        self.optimizer_name = get_optimizer_name(param_dict)
        if self.optimizer_name is not None and self.optimizer_name.lower() in DEEPSPEED_OPTIMIZERS:
            self.optimizer_name = self.optimizer_name.lower()
        self.optimizer_params = get_optimizer_params(param_dict)
        self.optimizer_legacy_fusion = get_optimizer_legacy_fusion(param_dict)

        self.scheduler_name = get_scheduler_name(param_dict)
        self.scheduler_params = get_scheduler_params(param_dict)

        mode = get_checkpoint_tag_validation_mode(param_dict)
        self.checkpoint_tag_validation_enabled = mode != CHECKPOINT_TAG_VALIDATION_IGNORE
        self.checkpoint_tag_validation_fail = mode == CHECKPOINT_TAG_VALIDATION_FAIL
        self.checkpoint_config = get_checkpoint_config(param_dict)
        self.resilience_config = get_resilience_config(param_dict)
        self.telemetry_config = DeepSpeedTelemetryConfig(param_dict)
        (self.pld_enabled, self.pld_theta,
         self.pld_gamma) = get_progressive_layer_drop(param_dict)
        self.serving_config = get_serving_config(param_dict)
        self.parallel_config = get_parallel_config(param_dict)
        self.fleet_config = get_fleet_config(param_dict)
        self.sparse_attention = get_sparse_attention(param_dict)
        self.pipeline = get_pipeline_config(param_dict)

    def _batch_assertion(self):
        train_batch = self.train_batch_size
        micro_batch = self.train_micro_batch_size_per_gpu
        grad_acc = self.gradient_accumulation_steps
        assert train_batch > 0, f"Train batch size: {train_batch} has to be greater than 0"
        assert micro_batch > 0, f"Micro batch size per gpu: {micro_batch} has to be greater than 0"
        assert grad_acc > 0, f"Gradient accumulation steps: {grad_acc} has to be greater than 0"
        assert train_batch == micro_batch * grad_acc * self.world_size, (
            f"Check batch related parameters. train_batch_size is not equal"
            " to micro_batch_per_gpu * gradient_acc_step * world_size"
            f" {train_batch} != {micro_batch} * {grad_acc} * {self.world_size}")

    def _set_batch_related_parameters(self):
        """Infer the missing members of the batch triple."""
        train_batch = self.train_batch_size
        micro_batch = self.train_micro_batch_size_per_gpu
        grad_acc = self.gradient_accumulation_steps

        if all(x is not None for x in [train_batch, micro_batch, grad_acc]):
            return
        elif train_batch is not None and micro_batch is not None:
            self.gradient_accumulation_steps = train_batch // micro_batch // self.world_size
        elif train_batch is not None and grad_acc is not None:
            self.train_micro_batch_size_per_gpu = train_batch // self.world_size // grad_acc
        elif micro_batch is not None and grad_acc is not None:
            self.train_batch_size = micro_batch * grad_acc * self.world_size
        elif train_batch is not None:
            self.gradient_accumulation_steps = 1
            self.train_micro_batch_size_per_gpu = train_batch // self.world_size
        elif micro_batch is not None:
            self.train_batch_size = micro_batch * self.world_size
            self.gradient_accumulation_steps = 1
        else:
            raise DeepSpeedConfigError(
                "Either train_batch_size or train_micro_batch_size_per_gpu needs to be provided")

    def _configure_train_batch_size(self):
        self._set_batch_related_parameters()
        self._batch_assertion()

    def _do_error_check(self):
        if self.fp16_enabled and self.bfloat16_enabled:
            raise DeepSpeedConfigError("fp16 and bf16 modes cannot both be enabled")
        if self.zero_enabled:
            assert self.zero_optimization_stage <= MAX_STAGE_ZERO_OPTIMIZATION, (
                f"DeepSpeedConfig: Maximum supported ZeRO stage is {MAX_STAGE_ZERO_OPTIMIZATION}")
            zc = self.zero_config
            for knob in ("reduce_bucket_size", "allgather_bucket_size"):
                val = getattr(zc, knob)
                if not isinstance(val, (int, float)) or isinstance(val, bool) or val <= 0:
                    raise DeepSpeedConfigError(
                        f"DeepSpeedConfig: zero_optimization.{knob} must be a "
                        f"positive number of elements, got {val!r}")
            if not isinstance(zc.overlap_comm, bool):
                raise DeepSpeedConfigError("DeepSpeedConfig: zero_optimization.overlap_comm "
                                           f"must be a boolean, got {zc.overlap_comm!r}")
            k = zc.offload_stream_buckets
            if not isinstance(k, int) or isinstance(k, bool) or k < 1:
                raise DeepSpeedConfigError(
                    "DeepSpeedConfig: zero_optimization.offload_stream_buckets "
                    f"must be an integer >= 1, got {k!r}")
            if not isinstance(zc.offload_pin_host, bool):
                raise DeepSpeedConfigError(
                    "DeepSpeedConfig: zero_optimization.offload_pin_host must "
                    f"be a boolean, got {zc.offload_pin_host!r}")
            if k > 1 and not zc.cpu_offload:
                raise DeepSpeedConfigError(
                    "DeepSpeedConfig: zero_optimization.offload_stream_buckets "
                    f"> 1 requires cpu_offload: true (got {k} without offload)")
        chunks = self.pipeline.get(PIPELINE_NUM_MODEL_CHUNKS, PIPELINE_NUM_MODEL_CHUNKS_DEFAULT)
        if not isinstance(chunks, int) or isinstance(chunks, bool) or chunks < 1:
            raise DeepSpeedConfigError(
                f"DeepSpeedConfig: pipeline.{PIPELINE_NUM_MODEL_CHUNKS} must be "
                f"an integer >= 1 (virtual stages per rank), got {chunks!r}")
        if chunks > 1:
            stages = self.pipeline.get(PIPELINE_STAGES)
            if stages is not None and self.gradient_accumulation_steps % int(stages) != 0:
                raise DeepSpeedConfigError(
                    f"DeepSpeedConfig: pipeline.{PIPELINE_NUM_MODEL_CHUNKS}="
                    f"{chunks} (interleaved 1F1B) requires "
                    f"gradient_accumulation_steps ({self.gradient_accumulation_steps}) "
                    f"divisible by pipeline stages ({stages})")

    def _check_ported(self, param_dict):
        """Refuse, by name, every enabled section this slice does not run."""
        todo = []
        if self.optimizer_name is not None and self.optimizer_name in DEEPSPEED_OPTIMIZERS \
                and self.optimizer_name not in PORTED_OPTIMIZERS:
            todo.append(f"optimizer {self.optimizer_name}")
        todo += [key for key in UNPORTED_SECTIONS if _section_enabled(param_dict, key)]
        if todo:
            raise NotImplementedError(
                f"not ported to deepspeed_tpu_torch yet: {', '.join(todo)} "
                "(ROADMAP.md, queue 1)")

    def print(self, name):
        logger.info(f"{name}:")
        for arg in sorted(vars(self)):
            if arg != "_param_dict":
                logger.info(f"  {arg} {'.' * (29 - len(arg))} {getattr(self, arg)}")
        logger.info(f"  json = {json.dumps(self._param_dict, sort_keys=True, indent=4)}")
