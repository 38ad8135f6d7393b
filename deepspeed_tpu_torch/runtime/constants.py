"""Config keys and defaults: the subset of ``deepspeed_tpu/runtime/constants.py``
the port reads. Keys stay source-compatible, so configs port unchanged."""

TRAIN_BATCH_SIZE = "train_batch_size"
TRAIN_MICRO_BATCH_SIZE_PER_GPU = "train_micro_batch_size_per_gpu"
GRADIENT_ACCUMULATION_STEPS = "gradient_accumulation_steps"

ZERO_ALLOW_UNTESTED_OPTIMIZER = "zero_allow_untested_optimizer"
ZERO_ALLOW_UNTESTED_OPTIMIZER_DEFAULT = False

OPTIMIZER = "optimizer"
OPTIMIZER_PARAMS = "params"
TYPE = "type"
SCHEDULER = "scheduler"
SCHEDULER_TYPE_DEFAULT = None
SCHEDULER_PARAMS = "params"
MAX_GRAD_NORM = "max_grad_norm"

ADAM_OPTIMIZER = "adam"
ADAMW_OPTIMIZER = "adamw"
LAMB_OPTIMIZER = "lamb"
ONEBIT_ADAM_OPTIMIZER = "onebitadam"
SGD_OPTIMIZER = "sgd"
DEEPSPEED_OPTIMIZERS = [ADAM_OPTIMIZER, ADAMW_OPTIMIZER, LAMB_OPTIMIZER,
                        ONEBIT_ADAM_OPTIMIZER, SGD_OPTIMIZER]
# what the port runs; the rest raise NotImplementedError
PORTED_OPTIMIZERS = (ADAM_OPTIMIZER, ADAMW_OPTIMIZER, LAMB_OPTIMIZER, SGD_OPTIMIZER)

FP16 = "fp16"
FP16_ENABLED = "enabled"
FP16_LOSS_SCALE = "loss_scale"
FP16_LOSS_SCALE_DEFAULT = 0
FP16_INITIAL_SCALE_POWER = "initial_scale_power"
FP16_INITIAL_SCALE_POWER_DEFAULT = 32
FP16_LOSS_SCALE_WINDOW = "loss_scale_window"
FP16_LOSS_SCALE_WINDOW_DEFAULT = 1000
FP16_HYSTERESIS = "hysteresis"
FP16_HYSTERESIS_DEFAULT = 2
FP16_MIN_LOSS_SCALE = "min_loss_scale"
FP16_MIN_LOSS_SCALE_DEFAULT = 1
BFLOAT16 = "bf16"
BFLOAT16_ALIAS = "bfloat16"
BFLOAT16_ENABLED = "enabled"

GRADIENT_CLIPPING = "gradient_clipping"
GRADIENT_CLIPPING_DEFAULT = 0.0
PRESCALE_GRADIENTS = "prescale_gradients"
PRESCALE_GRADIENTS_DEFAULT = False
GRADIENT_PREDIVIDE_FACTOR = "gradient_predivide_factor"
GRADIENT_PREDIVIDE_FACTOR_DEFAULT = 1.0

STEPS_PER_PRINT = "steps_per_print"
STEPS_PER_PRINT_DEFAULT = 10
SEED = "seed"
SEED_DEFAULT = 42

# sections and switches of the JAX config the port does not run yet: a
# config that enables one is refused by name
UNPORTED_SECTIONS = ("progressive_layer_drop", "pipeline", "sparse_attention",
                     "telemetry", "resilience", "flops_profiler", "amp", "elasticity",
                     "curriculum_learning", "tensorboard", "csv_monitor", "sentinel",
                     "tensor_parallel", "mesh", "checkpoint", "serving", "fleet",
                     "sparse_gradients", "wall_clock_breakdown", "memory_breakdown")
