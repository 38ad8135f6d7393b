"""deepspeed_tpu_torch: the PyTorch/CUDA port of deepspeed_tpu.

The port runs on an NVIDIA H100 (Hopper) with hand-written CUDA kernels
where the JAX package has Pallas kernels, and imports nothing of JAX or
of ``deepspeed_tpu``. Entry points run on the card unless the caller
passes ``device="cpu"``, where each kernel's plain PyTorch version runs.

Ported so far:

- serving: ``generate`` and the continuous-batching ``ServingEngine``
  over a GPT-2 model, on the paged decode-attention and banded
  sink+window attention kernels;
- training: ``initialize()`` -> ``engine.train_step`` / ``train_batch``
  for BERT pretraining (``BertForPreTraining``), bf16 or fp16 (static or
  dynamic loss scaling with overflow skips) with fp32 masters,
  Adam/AdamW, LAMB or SGD, the LR schedules, the engine's data loader
  over ``training_data=``, activation checkpointing, on the
  flash-attention forward, dq and dk/dv kernels with in-kernel dropout;
- data parallelism over ``torch.distributed`` (``init_distributed``) with
  ZeRO stages 1-3 and ZeRO-Offload (``zero_optimization``), the offload's
  Adam on the host kernel ``csrc/cpu_adam.cpp``.
"""

from deepspeed_tpu_torch import kernels
from deepspeed_tpu_torch.inference.generation import generate
from deepspeed_tpu_torch.inference.serving.config import ServingConfig
from deepspeed_tpu_torch.inference.serving.engine import ServingEngine
from deepspeed_tpu_torch.models.bert import BertConfig, BertForPreTraining, init_bert
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHeadModel, init_gpt2
from deepspeed_tpu_torch.ops.transformer.transformer import (
    DeepSpeedTransformerConfig,
    DeepSpeedTransformerLayer,
)
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig, DeepSpeedConfigError
from deepspeed_tpu_torch.runtime.engine import DeepSpeedEngine
from deepspeed_tpu_torch.runtime.zero import zero3_sharded_init
from deepspeed_tpu_torch.utils.distributed import init_distributed
from deepspeed_tpu_torch.utils.logging import log_dist
from deepspeed_tpu_torch.version import __version__


def initialize(args=None, model=None, optimizer=None, model_parameters=None,
               training_data=None, lr_scheduler=None, mpu=None, dist_init_required=None,
               collate_fn=None, config=None, config_params=None, device="cuda"):
    """Wrap ``model`` (a ``torch.nn.Module`` whose forward returns the
    loss) in a ``DeepSpeedEngine`` on ``device`` (the card unless the
    caller asks for the CPU). Returns ``(engine, optimizer,
    training_dataloader, lr_scheduler)`` as ``deepspeed_tpu.initialize``
    does."""
    log_dist(f"DeepSpeedTorch info: version={__version__}", ranks=[0])
    engine = DeepSpeedEngine(args=args, model=model, optimizer=optimizer,
                             model_parameters=model_parameters,
                             training_data=training_data, lr_scheduler=lr_scheduler,
                             mpu=mpu, dist_init_required=dist_init_required,
                             collate_fn=collate_fn, config=config,
                             config_params=config_params, device=device)
    return engine, engine.optimizer, engine.training_dataloader, engine.lr_scheduler


__all__ = ["BertConfig", "BertForPreTraining", "DeepSpeedConfig", "DeepSpeedConfigError",
           "DeepSpeedEngine", "DeepSpeedTransformerConfig", "DeepSpeedTransformerLayer",
           "GPT2Config", "GPT2LMHeadModel", "ServingConfig", "ServingEngine",
           "__version__", "generate", "init_bert", "init_distributed", "init_gpt2",
           "initialize", "kernels", "log_dist", "zero3_sharded_init"]
