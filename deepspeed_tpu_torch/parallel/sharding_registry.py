"""One ordered regex -> partition-spec rule table over parameter-tree paths.

Port of ``deepspeed_tpu/parallel/sharding_registry.py``: the same rule
tables (``SERVING_PARTITION_RULES``, ``TRAIN_PARTITION_RULES``), the same
first-match-wins resolution, the same named failures
(``UnmatchedPathError``, ``UnknownAxisError``, a rule longer than its
leaf). A spec is a tuple with one entry per leading dimension: an axis
name, a tuple of axis names, or None (the JAX ``PartitionSpec``'s
entries); ``()`` is replicated.

Placement works on local tensors, one process a rank: ``shard`` cuts a
whole tensor to this rank's part by its mesh coordinates, and ``gather``
all-gathers the parts back over the axes' process groups, bit for bit.
``shardings`` names the same placements as DTensor ``Shard`` /
``Replicate`` tuples, one per mesh axis.
"""

import re

import numpy as np

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.parallel.mesh import AXES, DATA_AXIS, MODEL_AXIS, create_mesh


class ShardingRegistryError(ValueError):
    """Base class for registry failures (a ValueError: bad rule tables
    are configuration errors)."""


class UnmatchedPathError(ShardingRegistryError):
    """A parameter-tree path matched no rule and ``replicate_unmatched``
    is off: the registry refuses to guess a placement."""


class UnknownAxisError(ShardingRegistryError):
    """A rule's spec names a mesh axis the target mesh (or configured
    ``mesh_shape``) does not define."""


# Serving/tensor-parallel rules for the GPT-2 scanned-layer tree (stacked
# leaves: kernels [L, in, out], biases [L, dim]): column-parallel qkv/ff1
# (output dim over `model`), row-parallel attn_out/ff2 (input dim over
# `model`), the paged KV pool and its scales over the heads dim, lane
# state and everything else replicated.
SERVING_PARTITION_RULES = {
    r"(qkv|ff1)/(kernel|kernel_q)$": (None, None, MODEL_AXIS),
    r"(qkv|ff1)/(bias|scale)$": (None, MODEL_AXIS),
    r"(attn_out|ff2)/(kernel|kernel_q)$": (None, MODEL_AXIS, None),
    r"^serving/kv_pool$": (None, None, MODEL_AXIS, None, None),
    r"^serving/kv_scale$": (None, None, MODEL_AXIS, None, None),
    r"^serving/prefill_kv$": (None, None, MODEL_AXIS, None, None),
    r"^serving/lane_state$": (),
    r".*": (),
}

# ZeRO train-engine placements: the flat master and gradient shards split
# over `data`, the gradient buckets and gathered parameters replicated,
# ZeRO-3's stored leaves split on their leading dim.
TRAIN_PARTITION_RULES = {
    r"^zero/flat_shard$": (DATA_AXIS,),
    r"^zero/grad_bucket$": (),
    r"^zero/gathered$": (),
    r"^zero3/stacked_leading$": (DATA_AXIS,),
}


def tree_path_str(path):
    """'/'-joined path of a tuple of keys."""
    return "/".join(str(p) for p in path)


def _spec_axes(spec):
    axes = []
    for entry in spec:
        if entry is None:
            continue
        axes.extend(entry if isinstance(entry, (tuple, list)) else (entry,))
    return tuple(axes)


def _walk(tree, fn, path=()):
    """``tree`` (nested dicts) with every leaf replaced by ``fn(path,
    leaf)``."""
    if isinstance(tree, dict):
        return {k: _walk(v, fn, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def _entry_axes(entry):
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def _local_part(mesh, leaf, spec):
    """This rank's part of the whole tensor ``leaf`` under ``spec``."""
    for dim, entry in enumerate(spec):
        axes = _entry_axes(entry)
        if not axes:
            continue
        n = int(np.prod([mesh.shape[a] for a in axes]))
        idx = 0
        for a in axes:
            idx = idx * mesh.shape[a] + mesh.rank(a)
        size = leaf.shape[dim] // n
        leaf = leaf.narrow(dim, idx * size, size)
    return leaf.contiguous()


def _gather_part(mesh, leaf, spec):
    """The whole tensor from every rank's ``_local_part``."""
    for dim, entry in enumerate(spec):
        for a in reversed(_entry_axes(entry)):
            leaf = comm.all_gather(leaf, mesh.group(a), axis=dim)
    return leaf


class ShardingRegistry:
    """Ordered first-match-wins regex -> spec rule table.

    ``rules`` is a dict (insertion-ordered) or an iterable of ``(pattern,
    spec)`` pairs. Patterns are ``re.search``-ed against '/'-joined tree
    paths. Scalar leaves always replicate. Unmatched paths raise
    :class:`UnmatchedPathError` unless ``replicate_unmatched`` is set."""

    def __init__(self, rules, replicate_unmatched=False, name="registry"):
        if isinstance(rules, dict):
            rules = rules.items()
        self.rules = [(pattern, re.compile(pattern), tuple(spec)) for pattern, spec in rules]
        self.replicate_unmatched = bool(replicate_unmatched)
        self.name = name

    def axes(self):
        """All axis names any rule mentions, in first-use order."""
        out = []
        for _, _, spec in self.rules:
            for ax in _spec_axes(spec):
                if ax not in out:
                    out.append(ax)
        return tuple(out)

    def validate_axes(self, mesh_axes):
        """Raise :class:`UnknownAxisError` if a rule names an axis outside
        ``mesh_axes`` (axis names, or a mesh)."""
        known = tuple(getattr(mesh_axes, "axis_names", mesh_axes))
        for pattern, _, spec in self.rules:
            for ax in _spec_axes(spec):
                if ax not in known:
                    raise UnknownAxisError(
                        f"{self.name}: rule {pattern!r} names axis {ax!r} but the mesh "
                        f"defines only {known}")
        return self

    def spec_for(self, path, ndim=None):
        """The first matching rule's spec for a '/'-joined path. ``ndim=0``
        resolves replicated; a spec longer than ``ndim`` raises."""
        if ndim == 0:
            return ()
        for pattern, rx, spec in self.rules:
            if rx.search(path):
                if ndim is not None and len(spec) > ndim:
                    raise ShardingRegistryError(
                        f"{self.name}: rule {pattern!r} spec {spec} has {len(spec)} entries "
                        f"but leaf '{path}' has only {ndim} dims")
                return spec
        if self.replicate_unmatched:
            return ()
        raise UnmatchedPathError(
            f"{self.name}: no rule matches param-tree path '{path}' "
            "(set replicate_unmatched=True to default to replication)")

    def specs(self, tree):
        """Nested dict of specs mirroring ``tree``."""
        return _walk(tree, lambda path, leaf: self.spec_for(tree_path_str(path),
                                                            ndim=len(np.shape(leaf))))

    def shardings(self, mesh, tree):
        """Nested dict of DTensor placement tuples (one per mesh axis)."""
        self.validate_axes(mesh)
        return _walk(self.specs(tree), lambda path, spec: placements(spec))

    def make_shard_fns(self, mesh, tree):
        """Per-leaf callables cutting a whole leaf to this rank's part."""
        self.validate_axes(mesh)
        return _walk(self.specs(tree),
                     lambda path, spec: (lambda leaf, _s=spec: _local_part(mesh, leaf, _s)))

    def make_gather_fns(self, mesh, tree):
        """Per-leaf callables gathering a rank's part back to the whole
        leaf (the bitwise round-trip partner of ``make_shard_fns``); a
        collective every rank joins."""
        self.validate_axes(mesh)
        return _walk(self.specs(tree),
                     lambda path, spec: (lambda leaf, _s=spec: _gather_part(mesh, leaf, _s)))

    def shard(self, mesh, tree):
        fns = self.make_shard_fns(mesh, tree)
        return _walk(tree, lambda path, leaf: _get(fns, path)(leaf))

    def gather(self, mesh, tree):
        fns = self.make_gather_fns(mesh, tree)
        return _walk(tree, lambda path, leaf: _get(fns, path)(leaf))

    def table(self):
        """The ordered {pattern: spec} view."""
        return {pattern: spec for pattern, _, spec in self.rules}


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def placements(spec):
    """DTensor placements (one per mesh axis, in mesh order) of a spec."""
    from torch.distributed.tensor import Replicate, Shard

    where = {}
    for dim, entry in enumerate(spec):
        for a in _entry_axes(entry):
            where[a] = dim
    return tuple(Shard(where[a]) if a in where else Replicate() for a in AXES)


def match_partition_rules(rules, tree, replicate_unmatched=False):
    """Functional one-shot: nested dict of specs for ``tree``."""
    return ShardingRegistry(rules, replicate_unmatched=replicate_unmatched).specs(tree)


def normalize_mesh_shape(mesh_shape):
    """(data, model) ints from a 2-sequence or {axis: size} dict."""
    if mesh_shape is None:
        return 1, 1
    if isinstance(mesh_shape, dict):
        unknown = [k for k in mesh_shape if k not in (DATA_AXIS, MODEL_AXIS)]
        if unknown:
            raise UnknownAxisError(
                f"mesh_shape names unknown axes {unknown!r}; serving meshes define "
                f"({DATA_AXIS!r}, {MODEL_AXIS!r})")
        data = int(mesh_shape.get(DATA_AXIS, 1))
        model = int(mesh_shape.get(MODEL_AXIS, 1))
    else:
        shape = tuple(int(v) for v in mesh_shape)
        if len(shape) != 2:
            raise ShardingRegistryError(f"mesh_shape must be (data, model), got {mesh_shape!r}")
        data, model = shape
    if data < 1 or model < 1:
        raise ShardingRegistryError(f"mesh_shape sizes must be >= 1, got ({data}, {model})")
    return data, model


def create_serving_mesh(mesh_shape):
    """The (pipe, data, model) mesh of a (data, model) shape over the
    running ranks, which must number data x model (one process a rank)."""
    from deepspeed_tpu_torch.utils.distributed import group_rank_and_size

    data, model = normalize_mesh_shape(mesh_shape)
    world = group_rank_and_size()[1]
    if world != data * model:
        raise ShardingRegistryError(
            f"mesh_shape ({data}, {model}) needs {data * model} ranks, have {world}")
    return create_mesh(data_parallel_size=data, model_parallel_size=model)


def serving_registry(extra_rules=None, replicate_unmatched=True):
    """The serving-side registry; ``extra_rules`` (ordered (pattern,
    spec) pairs) take precedence over the built-ins."""
    rules = list(extra_rules or []) + list(SERVING_PARTITION_RULES.items())
    return ShardingRegistry(rules, replicate_unmatched=replicate_unmatched,
                            name="serving_registry")


# The placements a port serving mesh runs, in ``parallel/tp.py``'s form
# (path regex over a layer's flax view, the dim from the end that carries
# the model axis): the built-in SERVING_PARTITION_RULES as explicit
# Megatron layers. Embeddings, norms and row-parallel biases replicate.
SERVING_TP_RULES = [
    (r"(qkv|ff1)/(kernel|bias)$", 1),
    (r"(attn_out|ff2)/kernel$", 2),
]

# the engine buffers the serving registry places, with their ranks
SERVING_BUFFERS = {"serving/kv_pool": 5, "serving/kv_scale": 5,
                   "serving/prefill_kv": 5, "serving/lane_state": 0}


def _canonical(spec):
    """A spec without trailing Nones (``(None, None)`` is ``()``)."""
    spec = tuple(spec)
    while spec and spec[-1] is None:
        spec = spec[:-1]
    return spec


def gpt2_serving_paths(model):
    """{JAX parameter-tree path: stacked rank} of a port
    ``GPT2LMHeadModel``'s leaves, as the JAX serving engine names them
    (the scanned layer stack under ``layers/DeepSpeedTransformerLayer_0``,
    every layer leaf with a leading [L] axis)."""
    from deepspeed_tpu_torch.parallel.tp import flax_view

    out = {}
    for name, (path, shape, _) in flax_view(model).items():
        parts = path.split("/")
        if parts[0] == "layers":
            path = "/".join(["layers", "DeepSpeedTransformerLayer_0"] + parts[2:])
            ndim = len(shape) + 1
        else:
            ndim = len(shape)
        out[f"params/transformer/{path}"] = ndim
    return out


def check_serving_placement(registry, model):
    """Hold ``registry`` (the built-ins under the user's ``partition_rules``)
    to the placements a port serving mesh runs: every GPT-2 leaf and engine
    buffer must resolve to the spec the built-in table gives it (qkv and
    ff1 by column, attn_out and ff2 by row, the KV pool over its heads,
    everything else replicated). The port's layers are explicit Megatron
    layers, so any other placement is refused, naming the leaf."""
    builtin = serving_registry()
    leaves = dict(gpt2_serving_paths(model))
    leaves.update(SERVING_BUFFERS)
    for path, ndim in leaves.items():
        want = _canonical(builtin.spec_for(path, ndim=ndim))
        got = _canonical(registry.spec_for(path, ndim=ndim))
        if got != want:
            raise NotImplementedError(
                f"serving partition_rules place '{path}' as {got}; a serving mesh of "
                f"deepspeed_tpu_torch places it as {want} (qkv/ff1 by column, "
                "attn_out/ff2 by row, the KV pool over its heads, the rest "
                "replicated) and has no other placement yet (ROADMAP.md)")
    return registry


def train_registry():
    """The train/ZeRO-side registry."""
    return ShardingRegistry(TRAIN_PARTITION_RULES, name="train_registry")


_TRAIN = None


def train_spec(path):
    """The spec of a named train placement (e.g. 'zero/flat_shard')."""
    global _TRAIN
    if _TRAIN is None:
        _TRAIN = train_registry()
    return _TRAIN.spec_for(path)


def train_sharding(mesh, path):
    """The DTensor placements of a named train placement."""
    return placements(train_spec(path))


def serving_spec(path, registry=None):
    """The spec of a named serving placement (e.g. 'serving/kv_pool')."""
    return (registry or serving_registry()).spec_for(path)


def serving_sharding(mesh, path, registry=None):
    """The DTensor placements of a named serving placement."""
    return placements(serving_spec(path, registry=registry))
