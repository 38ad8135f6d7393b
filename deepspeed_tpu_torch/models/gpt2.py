"""GPT-2 model family as PyTorch modules.

Port of ``deepspeed_tpu/models/gpt2.py`` for inference: the same
``GPT2Config`` fields and presets, and a ``GPT2LMHeadModel`` with token
and position embeddings, a list of ``DeepSpeedTransformerLayer``s, a
final LayerNorm and logits tied to the token table. ``init_gpt2`` draws
random weights from an explicit generator; ``from_jax_params`` converts
a flax parameter tree (as numpy arrays) into the module.
"""

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from deepspeed_tpu_torch.ops.transformer.transformer import (
    DeepSpeedTransformerConfig,
    DeepSpeedTransformerLayer,
)
from deepspeed_tpu_torch.runtime.activation_checkpointing.checkpointing import REMAT_POLICIES

_LINEARS = ("qkv", "attn_out", "ff1", "ff2")
_NORMS = ("ln_attn", "ln_ffn")


@dataclass
class GPT2Config:
    vocab_size: int = 50304  # padded to x128
    hidden_size: int = 1600
    num_hidden_layers: int = 48
    num_attention_heads: int = 25
    max_position_embeddings: int = 1024
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    initializer_range: float = 0.02
    checkpoint_activations: bool = False
    checkpoint_policy: str = "nothing"
    scan_unroll: int = 1

    def __post_init__(self):
        if self.checkpoint_policy not in REMAT_POLICIES:
            raise ValueError(
                f"checkpoint_policy must be one of {REMAT_POLICIES}, "
                f"got {self.checkpoint_policy!r}")

    @staticmethod
    def gpt2_xl(**kw):
        """~1.5B params (the reference's Megatron GPT-2 benchmark size)."""
        return GPT2Config(**kw)

    @staticmethod
    def gpt2_small(**kw):
        d = dict(hidden_size=768, num_hidden_layers=12, num_attention_heads=12)
        d.update(kw)
        return GPT2Config(**d)

    @staticmethod
    def gpt2_medium(**kw):
        d = dict(hidden_size=1024, num_hidden_layers=24, num_attention_heads=16)
        d.update(kw)
        return GPT2Config(**d)

    @staticmethod
    def gpt2_large(**kw):
        d = dict(hidden_size=1280, num_hidden_layers=36, num_attention_heads=20)
        d.update(kw)
        return GPT2Config(**d)

    @property
    def intermediate_size(self):
        return 4 * self.hidden_size

    def layer_config(self, training=True):
        return DeepSpeedTransformerConfig(
            hidden_size=self.hidden_size,
            intermediate_size=self.intermediate_size,
            heads=self.num_attention_heads,
            attn_dropout_ratio=self.attention_probs_dropout_prob,
            hidden_dropout_ratio=self.hidden_dropout_prob,
            num_hidden_layers=self.num_hidden_layers,
            initializer_range=self.initializer_range,
            pre_layer_norm=True,
            training=training,
            causal=True,
        )


class GPT2LMHeadModel(nn.Module):
    """Decoder-only transformer; ``forward(input_ids)`` returns the
    deterministic full-sequence logits [B, S, V]."""

    def __init__(self, config):
        super().__init__()
        self.config = config
        H = config.hidden_size
        self.wte = nn.Embedding(config.vocab_size, H)
        self.wpe = nn.Embedding(config.max_position_embeddings, H)
        layer_cfg = config.layer_config(training=False)
        self.layers = nn.ModuleList(
            DeepSpeedTransformerLayer(layer_cfg)
            for _ in range(config.num_hidden_layers))
        self.ln_f = nn.LayerNorm(H, eps=1e-6)

    def forward(self, input_ids):
        S = input_ids.shape[1]
        pos = torch.arange(S, device=input_ids.device)
        h = self.wte(input_ids) + self.wpe(pos)[None]
        for layer in self.layers:
            h = layer(h)
        h = self.ln_f(h)
        return h @ self.wte.weight.T.to(h.dtype)

    @classmethod
    def from_jax_params(cls, np_params, config):
        """Build the module from a flax ``GPT2LMHeadModel`` parameter tree
        given as numpy arrays. The scanned layer stack (one child under
        ``layers``, every leaf with a leading [L] axis) is unstacked, and
        each Dense kernel is transposed from flax's [in, out] to
        ``nn.Linear``'s [out, in]. The module lands on the CPU in the
        arrays' dtype."""
        tr = np_params["params"]["transformer"]
        children = list(tr["layers"].values())
        if len(children) != 1:
            raise ValueError(
                f"expected one scanned child under 'layers', got {list(tr['layers'])}")
        stack = children[0]
        dtype = torch.from_numpy(np.zeros(0, np.asarray(tr["wte"]["embedding"]).dtype)).dtype
        with torch.device("meta"):
            model = cls(config)
        model = model.to_empty(device="cpu").to(dtype)

        def put(param, array):
            array = np.asarray(array)
            if tuple(param.shape) != array.shape:
                raise ValueError(f"shape {array.shape} does not fit {tuple(param.shape)}")
            param.copy_(torch.from_numpy(np.array(array)))

        with torch.no_grad():
            put(model.wte.weight, tr["wte"]["embedding"])
            put(model.wpe.weight, tr["wpe"]["embedding"])
            put(model.ln_f.weight, tr["ln_f"]["scale"])
            put(model.ln_f.bias, tr["ln_f"]["bias"])
            for i, layer in enumerate(model.layers):
                for name in _LINEARS:
                    put(getattr(layer, name).weight, np.asarray(stack[name]["kernel"][i]).T)
                    put(getattr(layer, name).bias, stack[name]["bias"][i])
                for name in _NORMS:
                    put(getattr(layer, name).weight, stack[name]["scale"][i])
                    put(getattr(layer, name).bias, stack[name]["bias"][i])
        return model


def resolve_device(device):
    """The device an entry point runs on: CUDA unless the caller asks for
    another. A CUDA request without a card raises; nothing carries on
    silently on the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the plain "
                "PyTorch versions of the kernels on the CPU")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def init_gpt2(config, seed=0, device="cuda", dtype=torch.float32):
    """A ``GPT2LMHeadModel`` with random weights, as flax initializes them:
    embeddings and projection weights normal(0, initializer_range), biases
    zero, LayerNorm scales one. Weights are drawn in fp32 from an explicit
    ``torch.Generator`` on ``device`` seeded with ``seed``, then cast."""
    device = resolve_device(device)
    with torch.device("meta"):
        model = GPT2LMHeadModel(config)
    model = model.to_empty(device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    std = config.initializer_range

    def normal(param):
        w = torch.randn(param.shape, generator=gen, device=device,
                        dtype=torch.float32)
        param.copy_(w * std)

    with torch.no_grad():
        normal(model.wte.weight)
        normal(model.wpe.weight)
        for layer in model.layers:
            for name in _LINEARS:
                normal(getattr(layer, name).weight)
                getattr(layer, name).bias.zero_()
            for name in _NORMS:
                getattr(layer, name).weight.fill_(1.0)
                getattr(layer, name).bias.zero_()
        model.ln_f.weight.fill_(1.0)
        model.ln_f.bias.zero_()
    return model.to(dtype).eval()
