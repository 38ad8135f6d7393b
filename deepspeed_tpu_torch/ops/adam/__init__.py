"""Adam/AdamW of the port."""

from deepspeed_tpu_torch.ops.adam.fused_adam import AdamState, FusedAdam, decay_scales

__all__ = ["AdamState", "FusedAdam", "decay_scales"]
