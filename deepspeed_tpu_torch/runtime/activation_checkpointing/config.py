"""Activation-checkpointing sub-config (port of
``deepspeed_tpu/runtime/activation_checkpointing/config.py``).

The port runs ``enabled`` (per-layer recompute under the model's
``checkpoint_policy``); the other knobs of the section are collected in
``unported`` when set, and ``DeepSpeedConfig`` refuses them by name."""

ACTIVATION_CHKPT = "activation_checkpointing"
ACT_CHKPT_ENABLED = "enabled"
UNPORTED_KNOBS = ("partition_activations", "cpu_checkpointing",
                  "contiguous_memory_optimization", "number_checkpoints",
                  "synchronize_checkpoint_boundary", "profile")


class DeepSpeedActivationCheckpointingConfig:
    def __init__(self, param_dict):
        section = param_dict.get(ACTIVATION_CHKPT, {})
        self.enabled = section.get(ACT_CHKPT_ENABLED, False)
        self.unported = [k for k in UNPORTED_KNOBS if section.get(k)]

    def __repr__(self):
        return str(self.__dict__)
