"""LAMB of the port."""

from deepspeed_tpu_torch.ops.lamb.fused_lamb import FusedLamb, LambState

__all__ = ["FusedLamb", "LambState"]
