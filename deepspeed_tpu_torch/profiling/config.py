"""The ``flops_profiler`` and ``jax_sentinels`` config blocks.

Port of ``deepspeed_tpu/profiling/config.py``: the same keys, defaults
and errors. The sentinel block keeps the JAX config's key
``jax_sentinels``, so one config file arms the guards in either package.
"""

from deepspeed_tpu_torch.runtime.config_utils import get_scalar_param

FLOPS_PROFILER = "flops_profiler"

FLOPS_PROFILER_ENABLED = "enabled"
FLOPS_PROFILER_ENABLED_DEFAULT = False

FLOPS_PROFILER_PROFILE_STEP = "profile_step"
FLOPS_PROFILER_PROFILE_STEP_DEFAULT = 1

FLOPS_PROFILER_MODULE_DEPTH = "module_depth"
FLOPS_PROFILER_MODULE_DEPTH_DEFAULT = -1

FLOPS_PROFILER_TOP_MODULES = "top_modules"
FLOPS_PROFILER_TOP_MODULES_DEFAULT = 3

FLOPS_PROFILER_DETAILED = "detailed"
FLOPS_PROFILER_DETAILED_DEFAULT = True


JAX_SENTINELS = "jax_sentinels"

JAX_SENTINELS_ENABLED = "enabled"
JAX_SENTINELS_ENABLED_DEFAULT = False

# programs (distinct call signatures) a sentinel-wrapped hot function may
# accumulate before CompileSentinel raises; >= 1: the first call is
# always charged
JAX_SENTINELS_COMPILE_BUDGET = "compile_budget"
JAX_SENTINELS_COMPILE_BUDGET_DEFAULT = 4

# run the hot loop inside transfer_free(): an implicit host read of a
# device value raises instead of silently stalling the card
JAX_SENTINELS_TRANSFER_GUARD = "transfer_guard"
JAX_SENTINELS_TRANSFER_GUARD_DEFAULT = False


class DeepSpeedSentinelConfig:
    """``jax_sentinels`` block: the runtime program and transfer guards
    (``CompileSentinel`` budgets on the engines' hot functions and,
    optionally, ``transfer_free()`` around their steady state)."""

    def __init__(self, param_dict):
        sent_dict = param_dict.get(JAX_SENTINELS, {})
        if not isinstance(sent_dict, dict):
            raise ValueError(f"'{JAX_SENTINELS}' must be a dict, got {type(sent_dict).__name__}")
        self.enabled = get_scalar_param(sent_dict, JAX_SENTINELS_ENABLED, JAX_SENTINELS_ENABLED_DEFAULT)
        self.compile_budget = get_scalar_param(sent_dict, JAX_SENTINELS_COMPILE_BUDGET,
                                               JAX_SENTINELS_COMPILE_BUDGET_DEFAULT)
        self.transfer_guard = get_scalar_param(sent_dict, JAX_SENTINELS_TRANSFER_GUARD,
                                               JAX_SENTINELS_TRANSFER_GUARD_DEFAULT)
        if not isinstance(self.compile_budget, int) or isinstance(self.compile_budget, bool) \
                or self.compile_budget < 1:
            raise ValueError(
                f"'{JAX_SENTINELS}.{JAX_SENTINELS_COMPILE_BUDGET}' must be an int >= 1, "
                f"got {self.compile_budget!r}")

    def repr(self):
        return self.__dict__


class DeepSpeedFlopsProfilerConfig:
    def __init__(self, param_dict):
        prof_dict = param_dict.get(FLOPS_PROFILER, {})
        self.enabled = get_scalar_param(prof_dict, FLOPS_PROFILER_ENABLED, FLOPS_PROFILER_ENABLED_DEFAULT)
        self.profile_step = get_scalar_param(prof_dict, FLOPS_PROFILER_PROFILE_STEP, FLOPS_PROFILER_PROFILE_STEP_DEFAULT)
        self.module_depth = get_scalar_param(prof_dict, FLOPS_PROFILER_MODULE_DEPTH, FLOPS_PROFILER_MODULE_DEPTH_DEFAULT)
        self.top_modules = get_scalar_param(prof_dict, FLOPS_PROFILER_TOP_MODULES, FLOPS_PROFILER_TOP_MODULES_DEFAULT)
        self.detailed = get_scalar_param(prof_dict, FLOPS_PROFILER_DETAILED, FLOPS_PROFILER_DETAILED_DEFAULT)

    def repr(self):
        return self.__dict__
