"""fp16 mixed precision of the port: loss scaling and ``FP16_Optimizer``."""
