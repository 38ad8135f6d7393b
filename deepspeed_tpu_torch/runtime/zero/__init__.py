"""ZeRO of the port: stages 1-3 and ZeRO-Offload over a flat fp32 master,
sharded construction for stage 3, and the memory estimators (the
exports of ``deepspeed_tpu/runtime/zero/__init__.py`` but
``ZeroPytreeOptimizer``, which tensor parallelism needs)."""

from deepspeed_tpu_torch.runtime.zero.init import zero3_sharded_init
from deepspeed_tpu_torch.runtime.zero.mem_estimator import (
    estimate_zero2_model_states_mem_needs,
    estimate_zero_model_states_mem_needs,
    mem_needs_report,
)
from deepspeed_tpu_torch.runtime.zero.sharded_optimizer import (
    ZeroShardedOptimizer,
    zero3_param_shardings,
)

__all__ = [
    "ZeroShardedOptimizer",
    "zero3_param_shardings",
    "zero3_sharded_init",
    "estimate_zero_model_states_mem_needs",
    "estimate_zero2_model_states_mem_needs",
    "mem_needs_report",
]
