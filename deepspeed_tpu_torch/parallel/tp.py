"""Tensor (model) parallelism: Megatron's rules over the ``model`` axis.

Port of ``deepspeed_tpu/parallel/tp.py``. The rules are the JAX module's,
verbatim: (regex over a flax-style parameter path, the dimension counted
from the end that carries the model axis). Column-parallel products
(qkv, ff1) split their output features, row-parallel ones (attn_out,
ff2) their input features, embeddings their vocabulary; a dimension the
model axis does not divide stays replicated, as in JAX.

The decision is taken on each port parameter's flax path (``flax_view``:
``nn.Linear.weight`` is a flax ``kernel`` [in, out], so its dimension
flips; ``nn.Embedding.weight`` an ``embedding``; ``nn.LayerNorm.weight`` a
``scale``). Where JAX lets GSPMD insert the collectives, the port's
``shard_params`` puts explicit Megatron layers in place of the matched
modules, each holding its local shard as a plain parameter:

- ``ColumnParallelLinear``: the input enters through
  ``copy_to_model_region`` (identity forward, all-reduce backward); the
  output is gathered, unless the layer feeds a row-parallel partner;
- ``RowParallelLinear``: the input is this rank's part (sliced here
  unless a column-parallel partner produced it), the product is
  all-reduced (``reduce_from_model_region``) and the bias added once;
- ``VocabParallelEmbedding``: a masked lookup into the local rows, then an
  all-reduce; ``full_weight()`` gathers the table for a tied decoder.

Inside a ``DeepSpeedTransformerLayer`` the pairs qkv -> attn_out and ff1
-> ff2 run without the gather: qkv's fused [3H, H] weight is split by
head groups in each of q, k and v (``sections=3``), so a rank holds whole
heads, and the layer attends over its H / W local heads with the head
offset that makes dropout draw the whole layer's bits.
"""

import re

import torch
from torch import nn
import torch.nn.functional as F

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.parallel.mesh import MODEL_AXIS
from deepspeed_tpu_torch.utils.logging import logger

# (path regex, dim from the END that carries the model axis)
MEGATRON_RULES = [
    (r"(qkv|query|key|value|[qkv]_proj|up_proj|gate_proj|in_proj|ff1|intermediate|wi|fc1|c_fc)/(kernel|w)$", 1),
    (r"(qkv|query|key|value|[qkv]_proj|up_proj|gate_proj|in_proj|ff1|intermediate|wi|fc1|c_fc)/(bias|b)$", 1),
    (r"(attn_out|attention_out|out_proj|o_proj|down_proj|wo|fc2|ff2|c_proj|output_dense)/(kernel|w)$", 2),
    (r"(word_embeddings|wte|embedding|embed)/(embedding|kernel)$", 2),
]


def spec_for(path, shape, rules=MEGATRON_RULES, model_axis_size=None):
    """The spec (a tuple, one entry a dim; ``()`` replicated) of the leaf
    at flax-style ``path`` with flax-layout ``shape``: the matched rule's
    dim-from-end takes the model axis, unless ``model_axis_size`` does not
    divide it."""
    for pattern, dim_from_end in rules:
        if re.search(pattern, path):
            ndim = len(shape)
            if dim_from_end > ndim:
                continue
            dim = ndim - dim_from_end
            if model_axis_size is not None and shape[dim] % model_axis_size != 0:
                return ()
            spec = [None] * ndim
            spec[dim] = MODEL_AXIS
            return tuple(spec)
    return ()


def param_specs(tree, rules=MEGATRON_RULES, model_axis_size=None, path=()):
    """Nested dict of specs for a nested dict of flax-layout leaves."""
    if isinstance(tree, dict):
        return {k: param_specs(v, rules, model_axis_size, path + (k,)) for k, v in tree.items()}
    return spec_for("/".join(map(str, path)), tuple(tree.shape), rules, model_axis_size)


def flax_view(module):
    """{parameter name: (flax path, flax-layout shape, flips)}: the flax
    path of each of the module's parameters, where ``flips`` marks an
    ``nn.Linear`` weight (flax kernel [in, out], torch [out, in])."""
    owners = {}
    for mname, m in module.named_modules():
        for pname, _ in m.named_parameters(recurse=False):
            owners[f"{mname}.{pname}" if mname else pname] = (m, pname)
    view = {}
    for name, p in module.named_parameters():
        m, leaf = owners[name]
        parts = name.split(".")[:-1]
        shape, flips = tuple(p.shape), False
        if isinstance(m, (nn.Linear, ColumnParallelLinear, RowParallelLinear)) and \
                leaf == "weight":
            leaf, flips = "kernel", True
            shape = shape[::-1]
        elif isinstance(m, (nn.Embedding, VocabParallelEmbedding)) and leaf == "weight":
            leaf = "embedding"
        elif isinstance(m, nn.LayerNorm) and leaf == "weight":
            leaf = "scale"
        view[name] = ("/".join(parts + [leaf]), shape, flips)
    return view


def placement(module, model_axis_size, rules=MEGATRON_RULES):
    """{parameter name: the torch dim that carries the model axis, or
    None}: JAX's ``param_specs`` decision on the parameter's flax path."""
    out = {}
    for name, (path, shape, flips) in flax_view(module).items():
        spec = spec_for(path, shape, rules, model_axis_size)
        dim = spec.index(MODEL_AXIS) if spec else None
        if dim is not None and flips:
            dim = len(shape) - 1 - dim
        out[name] = dim
    return out


# ---------------------------------------------------------------------------
# local shards
# ---------------------------------------------------------------------------

def local_part(t, dim, rank, world, sections=1):
    """This rank's part of the whole tensor ``t`` along ``dim``: the dim is
    cut into ``sections`` equal sections and each section into ``world``
    parts (``sections=3`` splits q, k and v of a fused qkv alike)."""
    n = t.shape[dim]
    if n % (sections * world):
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split into "
                         f"{sections} sections x {world} ranks")
    m = n // (sections * world)
    pieces = [t.narrow(dim, s * (n // sections) + rank * m, m) for s in range(sections)]
    return torch.cat(pieces, dim=dim).contiguous()


def whole_of(t, dim, group, sections=1):
    """The whole tensor from every rank's ``local_part`` (a collective of
    ``group``)."""
    if comm.group_size(group) == 1:
        return t
    moved = t.movedim(dim, -1)
    return comm.gather_sections(moved, group, sections).movedim(-1, dim).contiguous()


class ColumnParallelLinear(nn.Module):
    """``nn.Linear`` whose output features are split over the model group
    (``sections`` alike sections, each split ``world`` ways)."""

    def __init__(self, linear, group, rank, world, sections=1, gather_output=True):
        super().__init__()
        self.group, self.rank, self.world = group, rank, world
        self.sections, self.gather_output = sections, gather_output
        self.in_features = linear.in_features
        self.out_features = linear.out_features
        self.weight = nn.Parameter(local_part(linear.weight.data, 0, rank, world, sections))
        self.bias = (nn.Parameter(local_part(linear.bias.data, 0, rank, world, sections))
                     if linear.bias is not None else None)
        self.tp_dims = {"weight": (0, sections), "bias": (0, sections)}

    def forward(self, x):
        y = F.linear(comm.copy_to_model_region(x, self.group), self.weight, self.bias)
        if self.gather_output:
            y = comm.gather_from_model_region(y, self.group, self.sections)
        return y


class RowParallelLinear(nn.Module):
    """``nn.Linear`` whose input features are split over the model group;
    the bias is added once, after the all-reduce."""

    def __init__(self, linear, group, rank, world, input_is_parallel=False):
        super().__init__()
        self.group, self.rank, self.world = group, rank, world
        self.input_is_parallel = input_is_parallel
        self.in_features = linear.in_features
        self.out_features = linear.out_features
        self.weight = nn.Parameter(local_part(linear.weight.data, 1, rank, world))
        self.bias = (nn.Parameter(linear.bias.data.clone())
                     if linear.bias is not None else None)
        self.tp_dims = {"weight": (1, 1)}

    def forward(self, x):
        if not self.input_is_parallel:
            x = comm.scatter_to_model_region(x, self.group)
        y = comm.reduce_from_model_region(F.linear(x, self.weight), self.group)
        return y if self.bias is None else y + self.bias


class VocabParallelEmbedding(nn.Module):
    """``nn.Embedding`` whose rows (the vocabulary) are split over the
    model group: a rank looks up the ids in its rows, zeroes the others,
    and the all-reduce sums the one nonzero row per id."""

    def __init__(self, emb, group, rank, world):
        super().__init__()
        self.group, self.rank, self.world = group, rank, world
        self.num_embeddings = emb.num_embeddings
        self.embedding_dim = emb.embedding_dim
        self.weight = nn.Parameter(local_part(emb.weight.data, 0, rank, world))
        self.tp_dims = {"weight": (0, 1)}

    def forward(self, ids):
        rows = self.weight.shape[0]
        lo = self.rank * rows
        outside = (ids < lo) | (ids >= lo + rows)
        out = F.embedding(torch.where(outside, 0, ids - lo), self.weight)
        out = torch.where(outside[..., None], torch.zeros((), dtype=out.dtype,
                                                          device=out.device), out)
        return comm.reduce_from_model_region(out, self.group)

    def full_weight(self):
        """The whole [V, H] table (all-gathered; the backward takes this
        rank's rows), for a decoder tied to the embedding."""
        return comm.gather_from_model_region(self.weight.t(), self.group).t()


def embedding_table(emb):
    """The whole table of an embedding, gathered when it is vocab-parallel."""
    return emb.full_weight() if isinstance(emb, VocabParallelEmbedding) else emb.weight


# ---------------------------------------------------------------------------
# placing a module on the mesh and gathering it back
# ---------------------------------------------------------------------------

def _set_child(module, name, child):
    parent_name, _, leaf = name.rpartition(".")
    parent = module.get_submodule(parent_name) if parent_name else module
    setattr(parent, leaf, child)


def shard_params(module, mesh, rules=MEGATRON_RULES, log=False):
    """Put the parallel layers in place of the ``nn.Linear`` /
    ``nn.Embedding`` modules whose weight the rules shard at the mesh's
    model size, in place; returns the module. A transformer layer's qkv ->
    attn_out and ff1 -> ff2 pairs skip the gather between them; any other
    matched linear gathers its output (column) or slices its input
    (row). A module already placed over the same model size is returned
    as it is."""
    from deepspeed_tpu_torch.ops.transformer.transformer import DeepSpeedTransformerLayer

    W = mesh.shape[MODEL_AXIS]
    if W == 1:
        return module
    held = {m.world for m in module.modules() if hasattr(m, "tp_dims")}
    if held:
        # placed already (a model handed to a second engine): in place once
        if held != {W}:
            raise ValueError(f"the module is sharded over model sizes {sorted(held)}, "
                             f"not {W}")
        return module
    group, rank = mesh.group(MODEL_AXIS), mesh.rank(MODEL_AXIS)
    dims = placement(module, W, rules)
    done = set()

    def col(name, lin, **kw):
        _set_child(module, name, ColumnParallelLinear(lin, group, rank, W, **kw))
        done.add(name)

    def row(name, lin, **kw):
        _set_child(module, name, RowParallelLinear(lin, group, rank, W, **kw))
        done.add(name)

    for lname, layer in list(module.named_modules()):
        if not isinstance(layer, DeepSpeedTransformerLayer):
            continue
        pre = f"{lname}." if lname else ""
        qkv_col = dims.get(f"{pre}qkv.weight") == 0 and dims.get(f"{pre}attn_out.weight") == 1
        if qkv_col:
            if layer.config.heads % W:
                raise ValueError(f"{lname}: {layer.config.heads} heads do not split over "
                                 f"tensor_parallel {W}")
            col(f"{pre}qkv", layer.qkv, sections=3, gather_output=False)
            row(f"{pre}attn_out", layer.attn_out, input_is_parallel=True)
            layer.tp = (group, rank, W)
        if dims.get(f"{pre}ff1.weight") == 0 and dims.get(f"{pre}ff2.weight") == 1:
            col(f"{pre}ff1", layer.ff1, gather_output=False)
            row(f"{pre}ff2", layer.ff2, input_is_parallel=True)
    for mname, m in list(module.named_modules()):
        if mname in done or not mname:
            continue
        dim = dims.get(f"{mname}.weight")
        if dim is None:
            continue
        if isinstance(m, nn.Linear):
            (col if dim == 0 else row)(mname, m)
        elif isinstance(m, nn.Embedding):
            _set_child(module, mname, VocabParallelEmbedding(m, group, rank, W))
            done.add(mname)
        else:
            raise NotImplementedError(
                f"{mname}: the rules shard a {type(m).__name__}, which has no "
                "tensor-parallel form in the port")
    if log:
        for name in sorted(done):
            logger.info(f"TP shard {name} over model={W}")
    return module


def sharded_params(module):
    """{parameter name: (dim, sections)} of every parameter held as a
    model-axis shard."""
    out = {}
    for mname, m in module.named_modules():
        for leaf, ds in getattr(m, "tp_dims", {}).items():
            if getattr(m, leaf, None) is not None:
                out[f"{mname}.{leaf}" if mname else leaf] = ds
    return out


def model_group_of(module):
    """The model group of the module's parallel layers (None without)."""
    for m in module.modules():
        if hasattr(m, "tp_dims"):
            return m.group
    return None


def gather_params(module):
    """{name: whole tensor} of every parameter, the sharded ones gathered
    over the model group (a collective of the group); the partner of
    ``shard_params`` for checkpoints and tests."""
    place = sharded_params(module)
    group = model_group_of(module)
    out = {}
    for name, p in module.named_parameters():
        t = p.detach()
        if name in place:
            dim, sections = place[name]
            t = whole_of(t, dim, group, sections)
        out[name] = t
    return out
