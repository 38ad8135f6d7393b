from deepspeed_tpu_torch.profiling.sentinels import (
    CompileBudgetExceededError,
    CompileSentinel,
    allowed_transfer,
    allowed_transfer_names,
    compile_cache_size,
    register_allowed_transfer,
    transfer_free,
)

__all__ = [
    "CompileBudgetExceededError",
    "CompileSentinel",
    "allowed_transfer",
    "allowed_transfer_names",
    "compile_cache_size",
    "register_allowed_transfer",
    "transfer_free",
]
