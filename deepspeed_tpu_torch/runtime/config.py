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
``zero_allow_untested_optimizer``, ``activation_checkpointing``,
``steps_per_print``, ``seed``, ``prescale_gradients`` and
``gradient_predivide_factor``. A config that enables a section or a
switch the port does not run yet raises ``NotImplementedError`` naming
it; nothing is silently ignored.
"""

import json
import os

import torch

from deepspeed_tpu_torch.runtime.activation_checkpointing.config import (
    DeepSpeedActivationCheckpointingConfig,
)
from deepspeed_tpu_torch.runtime.config_utils import (
    dict_raise_error_on_duplicate_keys,
    get_scalar_param,
)
from deepspeed_tpu_torch.runtime.constants import (
    BFLOAT16,
    BFLOAT16_ALIAS,
    BFLOAT16_ENABLED,
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
    SCHEDULER,
    SCHEDULER_PARAMS,
    SCHEDULER_TYPE_DEFAULT,
    SEED,
    SEED_DEFAULT,
    STEPS_PER_PRINT,
    STEPS_PER_PRINT_DEFAULT,
    TRAIN_BATCH_SIZE,
    TRAIN_MICRO_BATCH_SIZE_PER_GPU,
    TYPE,
    UNPORTED_SECTIONS,
    ZERO_ALLOW_UNTESTED_OPTIMIZER,
    ZERO_ALLOW_UNTESTED_OPTIMIZER_DEFAULT,
)
from deepspeed_tpu_torch.runtime.zero.config import DeepSpeedZeroConfig
from deepspeed_tpu_torch.runtime.zero.constants import (
    MAX_STAGE_ZERO_OPTIMIZATION,
    ZERO_OPTIMIZATION_DISABLED,
)
from deepspeed_tpu_torch.utils.logging import logger


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

        self._initialize_params(self._param_dict)
        self._configure_train_batch_size()
        self._do_error_check()
        self._check_ported(self._param_dict)

    def _initialize_params(self, param_dict):
        self.train_batch_size = get_scalar_param(param_dict, TRAIN_BATCH_SIZE, None)
        self.train_micro_batch_size_per_gpu = get_scalar_param(
            param_dict, TRAIN_MICRO_BATCH_SIZE_PER_GPU, None)
        self.gradient_accumulation_steps = get_scalar_param(
            param_dict, GRADIENT_ACCUMULATION_STEPS, None)
        self.steps_per_print = get_scalar_param(param_dict, STEPS_PER_PRINT,
                                                STEPS_PER_PRINT_DEFAULT)
        self.seed = get_scalar_param(param_dict, SEED, SEED_DEFAULT)
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

        self.fp16_enabled = get_fp16_enabled(param_dict)
        self.bfloat16_enabled = get_bfloat16_enabled(param_dict)
        self.loss_scale = get_loss_scale(param_dict)
        self.initial_dynamic_scale = get_initial_dynamic_scale(param_dict)
        self.dynamic_loss_scale_args = get_dynamic_loss_scale_args(param_dict)
        self.gradient_clipping = get_scalar_param(param_dict, GRADIENT_CLIPPING,
                                                  GRADIENT_CLIPPING_DEFAULT)

        self.optimizer_name = get_optimizer_name(param_dict)
        if self.optimizer_name is not None and self.optimizer_name.lower() in DEEPSPEED_OPTIMIZERS:
            self.optimizer_name = self.optimizer_name.lower()
        self.optimizer_params = get_optimizer_params(param_dict)

        self.scheduler_name = get_scheduler_name(param_dict)
        self.scheduler_params = get_scheduler_params(param_dict)

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

    def _check_ported(self, param_dict):
        """Refuse, by name, every enabled section this slice does not run."""
        todo = [f"activation_checkpointing.{k}"
                for k in self.activation_checkpointing_config.unported]
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
