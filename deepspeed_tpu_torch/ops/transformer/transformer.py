"""DeepSpeedTransformerLayer as a PyTorch module.

Port of ``deepspeed_tpu/ops/transformer/transformer.py``: the same config
surface and parameter names (``qkv``, ``attn_out``, ``ff1``, ``ff2``,
``ln_attn``, ``ln_ffn``), pre-LN and post-LN, hidden dropout, attention
dropout inside the ``flash_attention`` kernels, exact (erf) GELU, and
``_attention_core``'s routing between the fused kernel path and the
composed path.

Randomness is explicit: a training forward takes one integer
``dropout_seed``, and the layer derives its attention-dropout generator and
its hidden-dropout generator from it inside ``forward``. A recompute under
activation checkpointing calls ``forward`` again with the same integer, so
it draws the same masks without any global RNG state.
"""

import json
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from deepspeed_tpu_torch.ops.transformer.attention import flash_attention
from deepspeed_tpu_torch.runtime.utils import fold_seed


@dataclass
class DeepSpeedTransformerConfig:
    """Config surface of the JAX layer (reference transformer.py:25-121)."""

    batch_size: int = -1
    max_seq_length: int = -1
    hidden_size: int = -1
    intermediate_size: int = -1
    heads: int = -1
    attn_dropout_ratio: float = -1
    hidden_dropout_ratio: float = -1
    num_hidden_layers: int = -1
    initializer_range: float = -1
    local_rank: int = -1
    seed: int = -1
    fp16: bool = False
    bf16: bool = True
    pre_layer_norm: bool = True
    normalize_invertible: bool = False
    gelu_checkpoint: bool = False
    adjust_init_range: bool = True
    attn_dropout_checkpoint: bool = False
    stochastic_mode: bool = False
    huggingface: bool = False
    training: bool = True
    causal: bool = False

    @classmethod
    def from_dict(cls, json_object):
        config = cls()
        for key, value in json_object.items():
            if hasattr(config, key):
                setattr(config, key, value)
        return config

    @classmethod
    def from_json_file(cls, json_file):
        with open(json_file, "r", encoding="utf-8") as reader:
            return cls.from_dict(json.loads(reader.read()))


def _is_causal_mask(mask):
    """Is this additive [., ., S, S] mask exactly lower-triangular (0 on and
    below the diagonal, large-negative above)?"""
    m = mask.detach().float().cpu().numpy()
    S = m.shape[-1]
    tril = np.tril(np.ones((S, S), bool))
    return bool(np.all((m >= -1e-6) == tril))


def dropout(x, rate, generator):
    """Inverted dropout with an explicit generator (flax ``nn.Dropout``:
    keep with probability 1 - rate, kept values divided by it)."""
    if rate <= 0.0:
        return x
    keep_prob = 1.0 - rate
    u = torch.rand(x.shape, generator=generator, device=generator.device)
    keep = u.to(x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


def _attention_core(q, k, v, mask, dropout_ratio, deterministic, generator, causal=False):
    """Scaled masked attention softmax and PV: q, k, v [B, H, S, D]; mask an
    additive key bias [B, 1, 1, S] (or a full [., ., S, S] mask, which takes
    the composed path unless it is exactly causal)."""
    rate = 0.0 if deterministic else float(dropout_ratio)
    if rate == 0.0 or generator is not None:
        kw = dict(dropout_rate=rate, generator=generator if rate > 0 else None)
        if mask is None or (mask.ndim == 4 and mask.shape[-2] == 1 and mask.shape[1] == 1):
            return flash_attention(q, k, v, mask, causal=causal, **kw)
        if not causal and mask.ndim == 4 and mask.shape[-2] == mask.shape[-1]:
            if _is_causal_mask(mask):
                return flash_attention(q, k, v, None, causal=True, **kw)

    scale = 1.0 / torch.sqrt(torch.tensor(float(q.shape[-1]))).to(q.dtype)
    scores = torch.matmul(q, k.transpose(-1, -2)) * scale.to(q.device)
    if mask is not None:
        scores = scores + mask
    if causal:
        S = q.shape[2]
        cm = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        scores = torch.where(cm, scores, torch.tensor(-1e30, dtype=scores.dtype,
                                                      device=q.device))
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    if not deterministic and dropout_ratio > 0.0:
        probs = dropout(probs, float(dropout_ratio), generator)
    return torch.matmul(probs, v)


class DeepSpeedTransformerLayer(nn.Module):
    """BERT-style encoder (or, with ``causal``, decoder) layer:
    [pre-LN] -> QKV GEMM -> attention core -> attn-out GEMM -> dropout +
    residual -> [LN] -> FF1 -> GELU -> FF2 -> dropout + residual [-> LN]."""

    def __init__(self, config):
        super().__init__()
        self.config = config
        H = config.hidden_size
        self.qkv = nn.Linear(H, 3 * H)
        self.attn_out = nn.Linear(H, H)
        self.ff1 = nn.Linear(H, config.intermediate_size)
        self.ff2 = nn.Linear(config.intermediate_size, H)
        self.ln_attn = nn.LayerNorm(H, eps=1e-6)
        self.ln_ffn = nn.LayerNorm(H, eps=1e-6)

    def forward(self, hidden_states, attention_mask=None, deterministic=None,
                dropout_seed=None):
        cfg = self.config
        deterministic = not cfg.training if deterministic is None else deterministic
        B, S, H = hidden_states.shape
        nh = cfg.heads
        hd = H // nh
        attn_rate = max(cfg.attn_dropout_ratio, 0.0)
        hidden_rate = 0.0 if deterministic else max(cfg.hidden_dropout_ratio, 0.0)
        attn_gen = hidden_gen = None
        if not deterministic and (attn_rate > 0.0 or hidden_rate > 0.0):
            if dropout_seed is None:
                raise ValueError("a training forward with dropout needs a dropout_seed")
            attn_gen = torch.Generator().manual_seed(fold_seed(dropout_seed, 0))
            hidden_gen = torch.Generator(device=hidden_states.device).manual_seed(
                fold_seed(dropout_seed, 1))

        def attn_block(x):
            q, k, v = self.qkv(x).split(H, dim=-1)
            heads = lambda t: t.reshape(B, S, nh, hd).transpose(1, 2)
            ctx = _attention_core(heads(q), heads(k), heads(v), attention_mask, attn_rate,
                                  deterministic, attn_gen if attn_rate > 0.0 else None,
                                  causal=cfg.causal)
            return self.attn_out(ctx.transpose(1, 2).reshape(B, S, H))

        def ffn_block(x):
            return self.ff2(F.gelu(self.ff1(x)))

        drop = lambda t: dropout(t, hidden_rate, hidden_gen)
        if cfg.pre_layer_norm:
            x = hidden_states + drop(attn_block(self.ln_attn(hidden_states)))
            return x + drop(ffn_block(self.ln_ffn(x)))
        x = self.ln_attn(hidden_states + drop(attn_block(hidden_states)))
        return self.ln_ffn(x + drop(ffn_block(x)))
