"""Inference: KV-cache generation, beam search, int8 weights and
continuous-batching serving with its fleet."""

from deepspeed_tpu_torch.inference.beam import beam_search
from deepspeed_tpu_torch.inference.generation import generate, greedy_generate
from deepspeed_tpu_torch.inference.quantization import (
    dequantize_tensor,
    quantize_for_decode,
    quantize_tensor,
)
from deepspeed_tpu_torch.inference.serving import (
    QueueFullError,
    RequestTimeoutError,
    ServingConfig,
    ServingEngine,
)

__all__ = ["generate", "greedy_generate", "beam_search", "quantize_for_decode",
           "quantize_tensor", "dequantize_tensor", "ServingEngine", "ServingConfig",
           "QueueFullError", "RequestTimeoutError"]
