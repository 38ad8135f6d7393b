"""Activation-checkpointing sub-config (port of
``deepspeed_tpu/runtime/activation_checkpointing/config.py``): every key,
default and field of the JAX class.

``enabled`` makes the engine recompute the model's layers (or its whole
forward) in backward; ``cpu_checkpointing`` keeps the saved matmul
outputs in pinned host memory between forward and backward (the
``offload_dots`` policy). ``partition_activations``,
``contiguous_memory_optimization``, ``number_checkpoints``,
``synchronize_checkpoint_boundary`` and ``profile`` are flags that
``checkpointing.configure`` reads and checks, as in the JAX package."""

from deepspeed_tpu_torch.runtime.config_utils import get_scalar_param

ACTIVATION_CHKPT = "activation_checkpointing"

ACT_CHKPT_PARTITION_ACTIVATIONS = "partition_activations"
ACT_CHKPT_PARTITION_ACTIVATIONS_DEFAULT = False

ACT_CHKPT_NUMBER_CHECKPOINTS = "number_checkpoints"
ACT_CHKPT_NUMBER_CHECKPOINTS_DEFAULT = None

ACT_CHKPT_CONTIGUOUS_MEMORY_OPTIMIZATION = "contiguous_memory_optimization"
ACT_CHKPT_CONTIGUOUS_MEMORY_OPTIMIZATION_DEFAULT = False

ACT_CHKPT_SYNCHRONIZE_CHECKPOINT_BOUNDARY = "synchronize_checkpoint_boundary"
ACT_CHKPT_SYNCHRONIZE_CHECKPOINT_BOUNDARY_DEFAULT = False

ACT_CHKPT_PROFILE = "profile"
ACT_CHKPT_PROFILE_DEFAULT = False

ACT_CHKPT_CPU_CHECKPOINTING = "cpu_checkpointing"
ACT_CHKPT_CPU_CHECKPOINTING_DEFAULT = False

# the engine applies the recompute to any model when the section says so
ACT_CHKPT_ENABLED = "enabled"
ACT_CHKPT_ENABLED_DEFAULT = False

ACT_CHKPT_DEFAULT = {
    ACT_CHKPT_PARTITION_ACTIVATIONS: ACT_CHKPT_PARTITION_ACTIVATIONS_DEFAULT,
    ACT_CHKPT_NUMBER_CHECKPOINTS: ACT_CHKPT_NUMBER_CHECKPOINTS_DEFAULT,
    ACT_CHKPT_CONTIGUOUS_MEMORY_OPTIMIZATION: ACT_CHKPT_CONTIGUOUS_MEMORY_OPTIMIZATION_DEFAULT,
    ACT_CHKPT_SYNCHRONIZE_CHECKPOINT_BOUNDARY: ACT_CHKPT_SYNCHRONIZE_CHECKPOINT_BOUNDARY_DEFAULT,
    ACT_CHKPT_PROFILE: ACT_CHKPT_PROFILE_DEFAULT,
    ACT_CHKPT_CPU_CHECKPOINTING: ACT_CHKPT_CPU_CHECKPOINTING_DEFAULT,
}


class DeepSpeedActivationCheckpointingConfig:
    def __init__(self, param_dict):
        section = param_dict.get(ACTIVATION_CHKPT, ACT_CHKPT_DEFAULT)
        self.enabled = get_scalar_param(section, ACT_CHKPT_ENABLED, ACT_CHKPT_ENABLED_DEFAULT)
        self.partition_activations = get_scalar_param(
            section, ACT_CHKPT_PARTITION_ACTIVATIONS, ACT_CHKPT_PARTITION_ACTIVATIONS_DEFAULT)
        self.contiguous_memory_optimization = get_scalar_param(
            section, ACT_CHKPT_CONTIGUOUS_MEMORY_OPTIMIZATION,
            ACT_CHKPT_CONTIGUOUS_MEMORY_OPTIMIZATION_DEFAULT)
        self.cpu_checkpointing = get_scalar_param(
            section, ACT_CHKPT_CPU_CHECKPOINTING, ACT_CHKPT_CPU_CHECKPOINTING_DEFAULT)
        self.number_checkpoints = get_scalar_param(
            section, ACT_CHKPT_NUMBER_CHECKPOINTS, ACT_CHKPT_NUMBER_CHECKPOINTS_DEFAULT)
        self.profile = get_scalar_param(section, ACT_CHKPT_PROFILE, ACT_CHKPT_PROFILE_DEFAULT)
        self.synchronize_checkpoint_boundary = get_scalar_param(
            section, ACT_CHKPT_SYNCHRONIZE_CHECKPOINT_BOUNDARY,
            ACT_CHKPT_SYNCHRONIZE_CHECKPOINT_BOUNDARY_DEFAULT)

    def repr(self):
        return self.__dict__

    def __repr__(self):
        return str(self.__dict__)
