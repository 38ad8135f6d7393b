"""Activation checkpointing (rematerialization) of the port."""

from deepspeed_tpu_torch.runtime.activation_checkpointing import checkpointing  # noqa: F401
