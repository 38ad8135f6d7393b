"""ZeRO config keys and defaults (port of ``deepspeed_tpu/runtime/zero/constants.py``,
every key and default of it)."""

ZERO_FORMAT = """
ZeRO optimization should be enabled as:
"zero_optimization": {
  "stage": [0|1|2|3],
  "allgather_partitions": [true|false],
  "allgather_bucket_size": 500000000,
  "overlap_comm": [true|false],
  "reduce_scatter": [true|false],
  "reduce_bucket_size": 500000000,
  "contiguous_gradients": [true|false],
  "cpu_offload": [true|false],
  "offload_stream_buckets": 1,
  "offload_pin_host": [true|false],
  "elastic_checkpoint": [true|false]
}
"""

ZERO_OPTIMIZATION = "zero_optimization"

ZERO_OPTIMIZATION_DISABLED = 0
ZERO_OPTIMIZATION_OPTIMIZER_STATES = 1
ZERO_OPTIMIZATION_GRADIENTS = 2
ZERO_OPTIMIZATION_WEIGHTS = 3
MAX_STAGE_ZERO_OPTIMIZATION = ZERO_OPTIMIZATION_WEIGHTS

ZERO_OPTIMIZATION_STAGE = "stage"
ZERO_OPTIMIZATION_STAGE_DEFAULT = ZERO_OPTIMIZATION_DISABLED

ZERO_OPTIMIZATION_ALLGATHER_PARTITIONS = "allgather_partitions"
ZERO_OPTIMIZATION_ALLGATHER_PARTITIONS_DEFAULT = True

ZERO_OPTIMIZATION_REDUCE_SCATTER = "reduce_scatter"
ZERO_OPTIMIZATION_REDUCE_SCATTER_DEFAULT = True

ZERO_OPTIMIZATION_OVERLAP_COMM = "overlap_comm"
ZERO_OPTIMIZATION_OVERLAP_COMM_DEFAULT = False

ZERO_OPTIMIZATION_CONTIGUOUS_GRADIENTS = "contiguous_gradients"
ZERO_OPTIMIZATION_CONTIGUOUS_GRADIENTS_DEFAULT = False

ZERO_OPTIMIZATION_REDUCE_BUCKET_SIZE = "reduce_bucket_size"
ZERO_OPTIMIZATION_REDUCE_BUCKET_SIZE_DEFAULT = 500000000

ZERO_OPTIMIZATION_ALLGATHER_BUCKET_SIZE = "allgather_bucket_size"
ZERO_OPTIMIZATION_ALLGATHER_BUCKET_SIZE_DEFAULT = 500000000
# deprecated alias accepted by the reference
ZERO_OPTIMIZATION_ALLGATHER_BUCKET_SIZE_DEPRECATED = "allgather_size"

ZERO_OPTIMIZATION_CPU_OFFLOAD = "cpu_offload"
ZERO_OPTIMIZATION_CPU_OFFLOAD_DEFAULT = False

# Number of grad/param buckets the offloaded host step streams through its
# D2H -> host-Adam -> H2D pipeline. 1 (default) keeps the sequential
# leaf-at-a-time host step; >= 2 enables the double-buffered stream.
ZERO_OPTIMIZATION_OFFLOAD_STREAM_BUCKETS = "offload_stream_buckets"
ZERO_OPTIMIZATION_OFFLOAD_STREAM_BUCKETS_DEFAULT = 1

# Keep the streamed path's ping-pong master pair persistent across steps
# (the pinned-double-buffer discipline of ZeRO-Offload): the out-of-place
# host step alternates between two preallocated full masters, steady-state
# zero allocation. With it off a fresh partner buffer is allocated every
# step, which also avoids any aliasing between param generations.
ZERO_OPTIMIZATION_OFFLOAD_PIN_HOST = "offload_pin_host"
ZERO_OPTIMIZATION_OFFLOAD_PIN_HOST_DEFAULT = True

ZERO_OPTIMIZATION_ELASTIC_CHECKPOINT = "elastic_checkpoint"
ZERO_OPTIMIZATION_ELASTIC_CHECKPOINT_DEFAULT = True

ZERO_OPTIMIZATION_DEFAULT = {
    ZERO_OPTIMIZATION_STAGE: ZERO_OPTIMIZATION_STAGE_DEFAULT,
}
