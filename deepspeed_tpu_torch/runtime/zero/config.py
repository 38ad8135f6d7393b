"""Typed ZeRO sub-config (port of ``deepspeed_tpu/runtime/zero/config.py``):
every key of ``zero_optimization`` with the JAX package's defaults, the
deprecated boolean form (``"zero_optimization": true`` is stage 1, with
the top-level ``allgather_size`` as the all-gather bucket size)."""

from deepspeed_tpu_torch.runtime.config_utils import get_scalar_param
from deepspeed_tpu_torch.runtime.zero.constants import (
    ZERO_FORMAT,
    ZERO_OPTIMIZATION,
    ZERO_OPTIMIZATION_ALLGATHER_BUCKET_SIZE,
    ZERO_OPTIMIZATION_ALLGATHER_BUCKET_SIZE_DEFAULT,
    ZERO_OPTIMIZATION_ALLGATHER_BUCKET_SIZE_DEPRECATED,
    ZERO_OPTIMIZATION_ALLGATHER_PARTITIONS,
    ZERO_OPTIMIZATION_ALLGATHER_PARTITIONS_DEFAULT,
    ZERO_OPTIMIZATION_CONTIGUOUS_GRADIENTS,
    ZERO_OPTIMIZATION_CONTIGUOUS_GRADIENTS_DEFAULT,
    ZERO_OPTIMIZATION_CPU_OFFLOAD,
    ZERO_OPTIMIZATION_CPU_OFFLOAD_DEFAULT,
    ZERO_OPTIMIZATION_DEFAULT,
    ZERO_OPTIMIZATION_ELASTIC_CHECKPOINT,
    ZERO_OPTIMIZATION_ELASTIC_CHECKPOINT_DEFAULT,
    ZERO_OPTIMIZATION_OFFLOAD_PIN_HOST,
    ZERO_OPTIMIZATION_OFFLOAD_PIN_HOST_DEFAULT,
    ZERO_OPTIMIZATION_OFFLOAD_STREAM_BUCKETS,
    ZERO_OPTIMIZATION_OFFLOAD_STREAM_BUCKETS_DEFAULT,
    ZERO_OPTIMIZATION_OVERLAP_COMM,
    ZERO_OPTIMIZATION_OVERLAP_COMM_DEFAULT,
    ZERO_OPTIMIZATION_REDUCE_BUCKET_SIZE,
    ZERO_OPTIMIZATION_REDUCE_BUCKET_SIZE_DEFAULT,
    ZERO_OPTIMIZATION_REDUCE_SCATTER,
    ZERO_OPTIMIZATION_REDUCE_SCATTER_DEFAULT,
    ZERO_OPTIMIZATION_STAGE,
    ZERO_OPTIMIZATION_STAGE_DEFAULT,
)
from deepspeed_tpu_torch.utils.logging import logger

# (attribute, key, default) of every field
_FIELDS = (
    ("stage", ZERO_OPTIMIZATION_STAGE, ZERO_OPTIMIZATION_STAGE_DEFAULT),
    ("contiguous_gradients", ZERO_OPTIMIZATION_CONTIGUOUS_GRADIENTS,
     ZERO_OPTIMIZATION_CONTIGUOUS_GRADIENTS_DEFAULT),
    ("reduce_scatter", ZERO_OPTIMIZATION_REDUCE_SCATTER, ZERO_OPTIMIZATION_REDUCE_SCATTER_DEFAULT),
    ("reduce_bucket_size", ZERO_OPTIMIZATION_REDUCE_BUCKET_SIZE,
     ZERO_OPTIMIZATION_REDUCE_BUCKET_SIZE_DEFAULT),
    ("allgather_partitions", ZERO_OPTIMIZATION_ALLGATHER_PARTITIONS,
     ZERO_OPTIMIZATION_ALLGATHER_PARTITIONS_DEFAULT),
    ("allgather_bucket_size", ZERO_OPTIMIZATION_ALLGATHER_BUCKET_SIZE,
     ZERO_OPTIMIZATION_ALLGATHER_BUCKET_SIZE_DEFAULT),
    ("overlap_comm", ZERO_OPTIMIZATION_OVERLAP_COMM, ZERO_OPTIMIZATION_OVERLAP_COMM_DEFAULT),
    ("cpu_offload", ZERO_OPTIMIZATION_CPU_OFFLOAD, ZERO_OPTIMIZATION_CPU_OFFLOAD_DEFAULT),
    ("offload_stream_buckets", ZERO_OPTIMIZATION_OFFLOAD_STREAM_BUCKETS,
     ZERO_OPTIMIZATION_OFFLOAD_STREAM_BUCKETS_DEFAULT),
    ("offload_pin_host", ZERO_OPTIMIZATION_OFFLOAD_PIN_HOST,
     ZERO_OPTIMIZATION_OFFLOAD_PIN_HOST_DEFAULT),
    ("elastic_checkpoint", ZERO_OPTIMIZATION_ELASTIC_CHECKPOINT,
     ZERO_OPTIMIZATION_ELASTIC_CHECKPOINT_DEFAULT),
)


class DeepSpeedZeroConfig:
    def __init__(self, param_dict):
        if ZERO_OPTIMIZATION in param_dict:
            zero_config_dict = param_dict[ZERO_OPTIMIZATION]
            if isinstance(zero_config_dict, bool):
                zero_config_dict = self.read_zero_config_deprecated(param_dict)
        else:
            zero_config_dict = ZERO_OPTIMIZATION_DEFAULT
        for attr, key, default in _FIELDS:
            setattr(self, attr, get_scalar_param(zero_config_dict, key, default))

    def read_zero_config_deprecated(self, param_dict):
        zero_config_dict = {ZERO_OPTIMIZATION_STAGE: 1 if param_dict[ZERO_OPTIMIZATION] else 0}
        if zero_config_dict[ZERO_OPTIMIZATION_STAGE] > 0:
            zero_config_dict[ZERO_OPTIMIZATION_ALLGATHER_BUCKET_SIZE] = get_scalar_param(
                param_dict, ZERO_OPTIMIZATION_ALLGATHER_BUCKET_SIZE_DEPRECATED,
                ZERO_OPTIMIZATION_ALLGATHER_BUCKET_SIZE_DEFAULT)
        logger.warning("DeepSpeedConfig: this format of ZeRO optimization setup is deprecated. "
                       f"Please use the following format: {ZERO_FORMAT}")
        return zero_config_dict

    def repr(self):
        return {attr: getattr(self, attr) for attr, _, _ in _FIELDS}

    def __repr__(self):
        return str(self.repr())
