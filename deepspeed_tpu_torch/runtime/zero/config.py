"""Typed ZeRO sub-config (port of ``deepspeed_tpu/runtime/zero/config.py``):
the stage and the offload switch. The port runs stage 0; ``DeepSpeedConfig``
refuses the others."""

from deepspeed_tpu_torch.runtime.config_utils import get_scalar_param
from deepspeed_tpu_torch.runtime.zero.constants import (
    ZERO_OPTIMIZATION,
    ZERO_OPTIMIZATION_CPU_OFFLOAD,
    ZERO_OPTIMIZATION_CPU_OFFLOAD_DEFAULT,
    ZERO_OPTIMIZATION_STAGE,
    ZERO_OPTIMIZATION_STAGE_DEFAULT,
)


class DeepSpeedZeroConfig:
    def __init__(self, param_dict):
        zero = param_dict.get(ZERO_OPTIMIZATION, {})
        if isinstance(zero, bool):  # the deprecated boolean form: true means stage 1
            zero = {ZERO_OPTIMIZATION_STAGE: 1 if zero else 0}
        self.stage = get_scalar_param(zero, ZERO_OPTIMIZATION_STAGE,
                                      ZERO_OPTIMIZATION_STAGE_DEFAULT)
        self.cpu_offload = get_scalar_param(zero, ZERO_OPTIMIZATION_CPU_OFFLOAD,
                                            ZERO_OPTIMIZATION_CPU_OFFLOAD_DEFAULT)

    def __repr__(self):
        return str(dict(stage=self.stage, cpu_offload=self.cpu_offload))
