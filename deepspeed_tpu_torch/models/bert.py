"""BERT model family for pretraining, as PyTorch modules.

Port of ``deepspeed_tpu/models/bert.py``: ``BertConfig`` (with the
``bert_large`` and ``bert_base`` presets), embeddings with flax's
LayerNorm epsilon (1e-6), an encoder of ``DeepSpeedTransformerLayer``s
with per-layer activation checkpointing, the pooler, and the pretraining
heads (MLM transform, exact GELU, LayerNorm, the decoder tied to the word
embeddings plus ``mlm_bias``, chunked cross-entropy; NSP head and
cross-entropy).

Dropout draws from one integer ``dropout_seed`` per forward: layer ``i``
gets ``fold_seed(dropout_seed, i)`` and the embeddings
``fold_seed(dropout_seed, L)``, derived before any checkpointed call (the
counterpart of ``split_rngs`` over the scanned layers in JAX), so a
recompute draws the masks it drew the first time.

Progressive layer drop and ``BertForQuestionAnswering`` are not ported
yet.
"""

import math
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from deepspeed_tpu_torch.models.gpt2 import resolve_device
from deepspeed_tpu_torch.ops.cross_entropy import chunked_cross_entropy
from deepspeed_tpu_torch.ops.transformer.transformer import (
    DeepSpeedTransformerConfig,
    DeepSpeedTransformerLayer,
    dropout,
)
from deepspeed_tpu_torch.runtime.activation_checkpointing.checkpointing import (
    checkpoint_call,
    resolve_remat_policy,
)
from deepspeed_tpu_torch.runtime.utils import fold_seed

_LINEARS = ("qkv", "attn_out", "ff1", "ff2")
_NORMS = ("ln_attn", "ln_ffn")


@dataclass
class BertConfig:
    vocab_size: int = 30528  # padded to x128
    hidden_size: int = 1024
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: int = 4096
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    initializer_range: float = 0.02
    pre_layer_norm: bool = True
    checkpoint_activations: bool = False
    # with checkpoint_activations: "nothing" recomputes the whole layer,
    # "dots" saves the matmul outputs and recomputes the rest
    checkpoint_policy: str = "nothing"

    def __post_init__(self):
        resolve_remat_policy(self.checkpoint_policy)  # validates

    @staticmethod
    def bert_large(**kw):
        return BertConfig(**kw)

    @staticmethod
    def bert_base(**kw):
        d = dict(hidden_size=768, num_hidden_layers=12, num_attention_heads=12,
                 intermediate_size=3072)
        d.update(kw)
        return BertConfig(**d)

    def layer_config(self, training=True):
        return DeepSpeedTransformerConfig(
            hidden_size=self.hidden_size,
            intermediate_size=self.intermediate_size,
            heads=self.num_attention_heads,
            attn_dropout_ratio=self.attention_probs_dropout_prob,
            hidden_dropout_ratio=self.hidden_dropout_prob,
            num_hidden_layers=self.num_hidden_layers,
            initializer_range=self.initializer_range,
            pre_layer_norm=self.pre_layer_norm,
            training=training,
        )


class BertEmbeddings(nn.Module):
    def __init__(self, config):
        super().__init__()
        self.config = config
        H = config.hidden_size
        self.word_embeddings = nn.Embedding(config.vocab_size, H)
        self.position_embeddings = nn.Embedding(config.max_position_embeddings, H)
        self.token_type_embeddings = nn.Embedding(config.type_vocab_size, H)
        self.LayerNorm = nn.LayerNorm(H, eps=1e-6)

    def forward(self, input_ids, token_type_ids, deterministic, dropout_seed=None):
        positions = torch.arange(input_ids.shape[1], device=input_ids.device)[None, :]
        h = (self.word_embeddings(input_ids) + self.position_embeddings(positions)
             + self.token_type_embeddings(token_type_ids))
        h = self.LayerNorm(h)
        rate = self.config.hidden_dropout_prob
        if not deterministic and rate > 0.0:
            if dropout_seed is None:
                raise ValueError("a training forward with dropout needs a dropout_seed")
            gen = torch.Generator(device=h.device).manual_seed(fold_seed(dropout_seed, 1))
            h = dropout(h, rate, gen)
        return h


class BertEncoder(nn.Module):
    def __init__(self, config):
        super().__init__()
        self.config = config
        layer_cfg = config.layer_config()
        self.layers = nn.ModuleList(DeepSpeedTransformerLayer(layer_cfg)
                                    for _ in range(config.num_hidden_layers))

    def forward(self, hidden_states, attention_mask, deterministic, dropout_seed=None):
        cfg = self.config
        h = hidden_states
        for i, layer in enumerate(self.layers):
            seed = None if dropout_seed is None else fold_seed(dropout_seed, i)
            if cfg.checkpoint_activations and torch.is_grad_enabled():
                h = checkpoint_call(layer, h, attention_mask, deterministic, seed,
                                    policy=cfg.checkpoint_policy)
            else:
                h = layer(h, attention_mask, deterministic, seed)
        return h


class BertModel(nn.Module):
    def __init__(self, config):
        super().__init__()
        self.config = config
        self.embeddings = BertEmbeddings(config)
        self.encoder = BertEncoder(config)
        self.pooler = nn.Linear(config.hidden_size, config.hidden_size)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                deterministic=False, dropout_seed=None):
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        add_mask = (1.0 - attention_mask[:, None, None, :].float()) * -10000.0
        L = self.config.num_hidden_layers
        h = self.embeddings(input_ids, token_type_ids, deterministic,
                            None if dropout_seed is None else fold_seed(dropout_seed, L))
        h = self.encoder(h, add_mask.to(h.dtype), deterministic, dropout_seed)
        pooled = torch.tanh(self.pooler(h[:, 0]))
        return h, pooled, self.embeddings.word_embeddings.weight


def cross_entropy(logits, labels, ignore_index=-1):
    """Masked mean cross-entropy in fp32; labels == ignore_index add 0."""
    logits = logits.float()
    labels = labels.long()
    valid = labels != ignore_index
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, torch.where(valid, labels, 0)[..., None])[..., 0]
    nll = torch.where(valid, nll, 0.0)
    return nll.sum() / torch.clamp(valid.sum(), min=1)


class BertForPreTraining(nn.Module):
    """MLM + NSP pretraining heads; ``forward(batch...)`` returns the scalar
    loss (or, without labels, the MLM and NSP logits)."""

    needs_rng = True

    def __init__(self, config):
        super().__init__()
        self.config = config
        H = config.hidden_size
        self.bert = BertModel(config)
        self.mlm_transform = nn.Linear(H, H)
        self.mlm_ln = nn.LayerNorm(H, eps=1e-6)
        self.mlm_bias = nn.Parameter(torch.zeros(config.vocab_size))
        self.nsp_head = nn.Linear(H, 2)

    def forward(self, input_ids, token_type_ids, attention_mask, masked_lm_labels=None,
                next_sentence_label=None, deterministic=False, dropout_seed=None,
                progressive_layer_drop=False, pld_theta=None):
        if progressive_layer_drop:
            raise NotImplementedError("progressive layer drop is not ported yet")
        h, pooled, word_table = self.bert(input_ids, token_type_ids, attention_mask,
                                          deterministic, dropout_seed)
        t = self.mlm_ln(F.gelu(self.mlm_transform(h)))
        nsp_logits = self.nsp_head(pooled)
        decoder = word_table.T.to(t.dtype)
        if masked_lm_labels is None:
            return t @ decoder + self.mlm_bias.to(t.dtype), nsp_logits
        mlm_loss = chunked_cross_entropy(t, decoder, self.mlm_bias, masked_lm_labels,
                                         ignore_index=-1)
        if next_sentence_label is None:
            return mlm_loss
        return mlm_loss + cross_entropy(nsp_logits, next_sentence_label, ignore_index=-1)

    @classmethod
    def from_jax_params(cls, np_params, config):
        """Build the module from a flax ``BertForPreTraining`` parameter tree
        given as numpy arrays: the scanned ``encoder/layers`` child (every
        leaf with a leading [L] axis) is unstacked, and each Dense kernel
        is transposed from flax's [in, out] to ``nn.Linear``'s [out, in].
        The module lands on the CPU in the arrays' dtype."""
        p = np_params["params"]
        bert = p["bert"]
        children = list(bert["encoder"]["layers"].values())
        if len(children) != 1:
            raise ValueError(f"expected one scanned child under 'encoder/layers', "
                             f"got {list(bert['encoder']['layers'])}")
        stack = children[0]
        dtype = torch.from_numpy(np.zeros(0, np.asarray(p["mlm_bias"]).dtype)).dtype
        with torch.device("meta"):
            model = cls(config)
        model = model.to_empty(device="cpu").to(dtype)

        def put(param, array):
            array = np.asarray(array)
            if tuple(param.shape) != array.shape:
                raise ValueError(f"shape {array.shape} does not fit {tuple(param.shape)}")
            param.copy_(torch.from_numpy(np.array(array)))

        def dense(lin, tree, i=None):
            kernel, bias = tree["kernel"], tree["bias"]
            if i is not None:
                kernel, bias = kernel[i], bias[i]
            put(lin.weight, np.asarray(kernel).T)
            put(lin.bias, bias)

        def norm(ln, tree, i=None):
            scale, bias = tree["scale"], tree["bias"]
            if i is not None:
                scale, bias = scale[i], bias[i]
            put(ln.weight, scale)
            put(ln.bias, bias)

        with torch.no_grad():
            emb, e = bert["embeddings"], model.bert.embeddings
            put(e.word_embeddings.weight, emb["word_embeddings"]["embedding"])
            put(e.position_embeddings.weight, emb["position_embeddings"]["embedding"])
            put(e.token_type_embeddings.weight, emb["token_type_embeddings"]["embedding"])
            norm(e.LayerNorm, emb["LayerNorm"])
            for i, layer in enumerate(model.bert.encoder.layers):
                for name in _LINEARS:
                    dense(getattr(layer, name), stack[name], i)
                for name in _NORMS:
                    norm(getattr(layer, name), stack[name], i)
            dense(model.bert.pooler, bert["pooler"])
            dense(model.mlm_transform, p["mlm_transform"])
            norm(model.mlm_ln, p["mlm_ln"])
            put(model.mlm_bias, p["mlm_bias"])
            dense(model.nsp_head, p["nsp_head"])
        return model


class BertForQuestionAnswering(nn.Module):
    """The extractive-QA head of the JAX package: not ported yet."""

    def __init__(self, config):
        raise NotImplementedError("BertForQuestionAnswering is not ported yet "
                                  "(ROADMAP.md, queue 1)")


def bert_init_plan(model, gen):
    """``(parameter, fill)`` for every parameter of a ``BertForPreTraining``
    in ``init_bert``'s draw order: ``fill(t)`` writes the parameter's initial
    fp32 value into ``t``, drawing from ``gen`` (embeddings and the layers'
    Dense kernels normal(0, initializer_range); the pooler, MLM transform
    and NSP head kernels lecun-normal, a normal truncated at two deviations
    scaled to variance 1/fan_in; biases zero; LayerNorm scales one)."""
    config = model.config
    std = config.initializer_range if config.initializer_range > 0 else 0.02

    def normal(t):
        t.copy_(torch.randn(t.shape, generator=gen, device=t.device) * std)

    def lecun(t):
        s = math.sqrt(1.0 / t.shape[1]) / 0.87962566103423978
        nn.init.trunc_normal_(t, std=s, a=-2 * s, b=2 * s, generator=gen)

    zero = lambda t: t.zero_()
    one = lambda t: t.fill_(1.0)
    plan = []
    e = model.bert.embeddings
    for table in (e.word_embeddings, e.position_embeddings, e.token_type_embeddings):
        plan.append((table.weight, normal))
    plan += [(e.LayerNorm.weight, one), (e.LayerNorm.bias, zero)]
    for layer in model.bert.encoder.layers:
        for name in _LINEARS:
            plan += [(getattr(layer, name).weight, normal), (getattr(layer, name).bias, zero)]
        for name in _NORMS:
            plan += [(getattr(layer, name).weight, one), (getattr(layer, name).bias, zero)]
    for lin in (model.bert.pooler, model.mlm_transform, model.nsp_head):
        plan += [(lin.weight, lecun), (lin.bias, zero)]
    plan += [(model.mlm_ln.weight, one), (model.mlm_ln.bias, zero), (model.mlm_bias, zero)]
    return plan


def init_bert(config, seed=0, device="cuda", dtype=torch.float32):
    """A ``BertForPreTraining`` with random weights, initialized as flax
    does (``bert_init_plan``). Weights are drawn in fp32 from an explicit
    ``torch.Generator`` on ``device`` seeded with ``seed``, then cast to
    ``dtype``."""
    device = resolve_device(device)
    with torch.device("meta"):
        model = BertForPreTraining(config)
    model = model.to_empty(device=device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    with torch.no_grad():
        for param, fill in bert_init_plan(model, gen):
            fill(param)
    return model.to(dtype)
