"""Model families of the port."""

from deepspeed_tpu_torch.models.bert import BertConfig, BertForPreTraining, init_bert
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHeadModel, init_gpt2

__all__ = ["BertConfig", "BertForPreTraining", "GPT2Config", "GPT2LMHeadModel",
           "init_bert", "init_gpt2"]
