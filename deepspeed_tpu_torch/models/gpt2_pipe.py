"""GPT-2 expressed as a ``PipelineModule`` (a layer list) for pipeline
parallelism.

Port of ``deepspeed_tpu/models/gpt2_pipe.py``: [tied embedding, blocks,
final LayerNorm, tied head]. Each block is the port's
``DeepSpeedTransformerLayer`` under ``GPT2Config.layer_config()``
(pre-LN, causal), so its attention runs the three flash kernels; the
head projects onto the tied token table (``h @ wte.T``); the loss is the
next-token cross-entropy of ``models/bert.py``.

Under tensor parallelism (``PipelineModule.shard_layers``) a block's qkv
and ff1 split by columns and attn_out and ff2 by rows, so its flash
kernels run over the rank's heads at the rank's head offset (dropout
draws tensor_parallel 1's bits); the token table splits by vocabulary
and the tied head gathers it.

Every layer draws its initial weights from the generator the module
hands it (``init_weights``) and converts the JAX layer's flax tree
(``jax_state_dict``) for ``PipelineModule.load_jax_params``.
"""

import numpy as np
import torch
from torch import nn

from deepspeed_tpu_torch.models.bert import cross_entropy
from deepspeed_tpu_torch.ops.transformer.attention import DEFAULT_BLOCK
from deepspeed_tpu_torch.parallel.tp import embedding_table
from deepspeed_tpu_torch.ops.transformer.transformer import DeepSpeedTransformerLayer
from deepspeed_tpu_torch.runtime.pipe.module import LayerSpec, PipelineModule, TiedLayerSpec

_LINEARS = ("qkv", "attn_out", "ff1", "ff2")
_NORMS = ("ln_attn", "ln_ffn")
_BLOCKS = (128, 64, 32, 16)     # the flash kernels' tiles, largest first


def attention_block_for(seq_len, device):
    """The largest flash tile that divides ``seq_len`` (128 at GPT-2's
    1024). On the card a length none divides is refused: the kernels would
    not run it. On the CPU it takes the composed path at 128."""
    block = next((b for b in _BLOCKS if seq_len % b == 0), None)
    if block is not None:
        return block
    if torch.device(device).type == "cuda":
        raise ValueError(f"GPT2BlockPipe: sequence length {seq_len} is not a multiple of any "
                         f"flash attention tile {_BLOCKS}; pad it to a multiple of 16")
    return DEFAULT_BLOCK


def _normal_(param, generator, std):
    param.copy_(torch.randn(param.shape, generator=generator, device=param.device,
                            dtype=torch.float32) * std)


def _np(a):
    return torch.from_numpy(np.array(np.asarray(a), dtype=np.float32))


class GPT2EmbeddingPipe(nn.Module):
    """First pipeline layer: token plus position embeddings; also the
    owner of the tied token table the head projects onto."""

    def __init__(self, config):
        super().__init__()
        self.config = config
        self.wte = nn.Embedding(config.vocab_size, config.hidden_size)
        self.wpe = nn.Embedding(config.max_position_embeddings, config.hidden_size)

    def forward(self, input_ids):
        S = input_ids.shape[1]
        pos = torch.arange(S, device=input_ids.device)
        return self.wte(input_ids) + self.wpe(pos)[None]

    def init_weights(self, generator):
        with torch.no_grad():
            _normal_(self.wte.weight, generator, self.config.initializer_range)
            _normal_(self.wpe.weight, generator, self.config.initializer_range)

    @staticmethod
    def jax_state_dict(tree):
        p = tree["params"]
        return {"wte.weight": _np(p["wte"]["embedding"]),
                "wpe.weight": _np(p["wpe"]["embedding"])}


class GPT2BlockPipe(nn.Module):
    """One decoder layer (causal, in-kernel masking)."""

    def __init__(self, config):
        super().__init__()
        self.config = config
        self.layer = DeepSpeedTransformerLayer(config.layer_config())

    def forward(self, h, deterministic=None, dropout_seed=None):
        return self.layer(h, None, deterministic=deterministic, dropout_seed=dropout_seed,
                          attention_block=attention_block_for(h.shape[1], h.device))

    @property
    def param_count(self):
        return 12 * self.config.hidden_size ** 2

    def init_weights(self, generator):
        with torch.no_grad():
            for name in _LINEARS:
                lin = getattr(self.layer, name)
                _normal_(lin.weight, generator, self.config.initializer_range)
                lin.bias.zero_()
            for name in _NORMS:
                getattr(self.layer, name).weight.fill_(1.0)
                getattr(self.layer, name).bias.zero_()

    @staticmethod
    def jax_state_dict(tree):
        (p,) = tree["params"].values()     # DeepSpeedTransformerLayer_0
        out = {}
        for name in _LINEARS:
            out[f"layer.{name}.weight"] = _np(p[name]["kernel"]).T.contiguous()
            out[f"layer.{name}.bias"] = _np(p[name]["bias"])
        for name in _NORMS:
            out[f"layer.{name}.weight"] = _np(p[name]["scale"])
            out[f"layer.{name}.bias"] = _np(p[name]["bias"])
        return out


class GPT2FinalNormPipe(nn.Module):
    def __init__(self, config):
        super().__init__()
        self.config = config
        self.ln_f = nn.LayerNorm(config.hidden_size, eps=1e-6)

    def forward(self, h):
        return self.ln_f(h)

    def init_weights(self, generator):
        with torch.no_grad():
            self.ln_f.weight.fill_(1.0)
            self.ln_f.bias.zero_()

    @staticmethod
    def jax_state_dict(tree):
        p = tree["params"]["ln_f"]
        return {"ln_f.weight": _np(p["scale"]), "ln_f.bias": _np(p["bias"])}


def _lm_head_forward(layer, h):
    """Tied head: logits through the token table's transpose (gathered
    over the model group when the table is vocab-parallel)."""
    return h @ embedding_table(layer.wte).T.to(h.dtype)


def gpt2_loss_fn(logits, labels):
    """Next-token LM loss (labels are the input ids)."""
    return cross_entropy(logits[:, :-1], labels[:, 1:], ignore_index=-1)


def build_gpt2_pipeline(config, num_stages, partition_method="parameters", **pipe_kwargs):
    """GPT-2 as a layer list: [tied embed, blocks..., ln_f, tied head]."""
    layers = [TiedLayerSpec("embed", GPT2EmbeddingPipe, config)]
    layers += [LayerSpec(GPT2BlockPipe, config) for _ in range(config.num_hidden_layers)]
    layers += [
        LayerSpec(GPT2FinalNormPipe, config),
        TiedLayerSpec("embed", GPT2EmbeddingPipe, config, forward_fn=_lm_head_forward),
    ]
    return PipelineModule(layers, num_stages=num_stages, loss_fn=gpt2_loss_fn,
                          partition_method=partition_method, **pipe_kwargs)
