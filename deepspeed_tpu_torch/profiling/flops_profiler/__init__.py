from deepspeed_tpu_torch.profiling.flops_profiler.profiler import (
    FlopsProfiler,
    get_model_profile,
    flops_to_string,
    macs_to_string,
    params_to_string,
    duration_to_string,
)
