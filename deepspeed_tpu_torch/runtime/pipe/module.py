"""PipelineModule: a model expressed as a list of layers, partitioned into
pipeline stages.

Port of ``deepspeed_tpu/runtime/pipe/module.py``: ``LayerSpec`` deferred
construction, ``TiedLayerSpec`` weight tying (with a ``forward_fn`` for
the reuse sites), layer -> stage partitioning by ``uniform``,
``parameters`` or ``type:<regex>``, the interleaved-1F1B virtual stages,
and one seed per layer, so that initial weights do not depend on the
partitioning.

A layer is a ``torch.nn.Module`` (built from a spec on the ``meta``
device, so a 1.5 B-parameter model costs nothing until the engine
places it) or a parameterless callable. ``init_params`` materializes
every module layer on its stage's device and draws its weights from one
explicit ``torch.Generator`` on that device, seeded with ``base_seed +
layer index``: the layer's ``init_weights(generator)`` when it has one,
else a default rule (``default_init``). The users of a tied key start as
copies of its first layer (the owner). ``load_jax_params`` takes a JAX
``PipelineModule``'s per-layer parameter trees (as numpy arrays) in
place of the draws.
"""

import inspect
import math
import re

import torch
from torch import nn

from deepspeed_tpu_torch.runtime.pipe.schedule import call_to_str
from deepspeed_tpu_torch.runtime.pipe.topology import (
    PipeDataParallelTopology,
    PipelineParallelGrid,
)
from deepspeed_tpu_torch.runtime.utils import fold_seed, partition_balanced, partition_uniform
from deepspeed_tpu_torch.utils.logging import logger


class PipelineError(Exception):
    """Errors related to the use of ``PipelineModule`` and the pipeline
    engine."""


class LayerSpec:
    """Deferred layer construction: stores the class and its arguments so
    a layer is only built where it is needed."""

    def __init__(self, typename, *module_args, **module_kwargs):
        self.typename = typename
        self.module_args = module_args
        self.module_kwargs = module_kwargs
        if not issubclass(typename, object):
            raise RuntimeError("LayerSpec only supports classes")

    def build(self, log=False):
        if log:
            logger.info(f"building {repr(self)}")
        return self.typename(*self.module_args, **self.module_kwargs)

    def __repr__(self):
        return call_to_str(self.typename.__name__, *self.module_args, **self.module_kwargs)


class TiedLayerSpec(LayerSpec):
    """A ``LayerSpec`` whose parameters are shared with every other spec of
    the same ``key``. ``forward_fn(layer, *inputs)`` lets a reuse site run
    another computation over the tied parameters (an embedding lookup at
    the owner, the logit projection at the head)."""

    def __init__(self, key, typename, *module_args, forward_fn=None,
                 tied_weight_attr="embedding", **module_kwargs):
        super().__init__(typename, *module_args, **module_kwargs)
        self.key = key
        self.forward_fn = forward_fn
        self.tied_weight_attr = tied_weight_attr


_NORMS = (nn.LayerNorm, nn.GroupNorm, nn.BatchNorm1d, nn.BatchNorm2d)


def default_init(layer, generator):
    """Initial weights of a layer that has no ``init_weights``, drawn in
    fp32 from ``generator`` (on the layer's device) in the order of
    ``named_modules``: norm weights one and biases zero, embeddings
    normal(0, 1), every other parameter of rank >= 2 normal(0, 1 /
    sqrt(fan_in)) with fan_in the product of its trailing dimensions, and
    the rest zero. Buffers are zeroed."""
    with torch.no_grad():
        for mod in layer.modules():
            for name, p in mod.named_parameters(recurse=False):
                if isinstance(mod, _NORMS):
                    p.fill_(1.0 if name == "weight" else 0.0)
                elif isinstance(mod, nn.Embedding) or p.ndim >= 2:
                    std = 1.0 if isinstance(mod, nn.Embedding) else \
                        1.0 / math.sqrt(math.prod(p.shape[1:]))
                    p.copy_(torch.randn(p.shape, generator=generator, device=p.device,
                                        dtype=torch.float32) * std)
                else:
                    p.zero_()
        for b in layer.buffers():
            b.zero_()


def _accepts(fn, name):
    try:
        return name in inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return False


class PipelineModule(nn.Module):
    """Model-as-layer-list for pipeline-parallel execution.

    The arguments are the JAX module's: ``layers`` (specs, modules or
    callables), ``num_stages`` or ``topology``, ``loss_fn(outputs,
    labels)``, ``seed_layers``, ``seed_fn``, ``base_seed``,
    ``partition_method``, ``activation_checkpoint_interval``. A ``seed_fn``
    maps ``base_seed + index`` to the ``torch.Generator`` of that layer's
    initial weights.
    """

    def __init__(self, layers, num_stages=None, topology=None, loss_fn=None,
                 seed_layers=False, seed_fn=None, base_seed=1234,
                 partition_method="parameters", activation_checkpoint_interval=0,
                 activation_checkpoint_func=None):
        super().__init__()
        if num_stages is None and topology is None:
            raise RuntimeError("must provide num_stages or topology")
        self._layer_specs = list(layers)
        self._num_layers = len(self._layer_specs)
        self.loss_fn = loss_fn
        self.seed_layers = seed_layers
        self.seed_fn = seed_fn
        self.base_seed = base_seed
        self._partition_method = partition_method
        self.activation_checkpoint_interval = activation_checkpoint_interval
        self.activation_checkpoint_func = activation_checkpoint_func

        if topology is None:
            topology = PipeDataParallelTopology(num_pp=num_stages, num_dp=1)
        self._topo = topology
        self.num_stages = topology.get_dim("pipe")

        # layers built from specs start on the meta device: the partitioner
        # reads their parameter counts, init_params gives them storage
        self._from_spec = [isinstance(s, LayerSpec) for s in self._layer_specs]
        self._built = []
        for i, spec in enumerate(self._layer_specs):
            if isinstance(spec, LayerSpec):
                with torch.device("meta"):
                    layer = spec.build()
            else:
                layer = spec
            self._built.append(layer)
            if isinstance(layer, nn.Module):
                self.add_module(f"layer_{i:02d}", layer)
        # which of (dropout_seed, deterministic) each layer's forward takes,
        # read once here rather than on every call
        self._takes = [(_accepts(fn, "dropout_seed"), _accepts(fn, "deterministic"))
                       for fn in (m.forward if isinstance(m, nn.Module) else m
                                  for m in self._built)]
        self._materialized = False
        self._jax_states = {}

        self.parts = self._partition_layers(self._partition_method)

        # tied key -> indices of the layers sharing it (the first owns it)
        self.tied_specs = {}
        for i, spec in enumerate(self._layer_specs):
            if isinstance(spec, TiedLayerSpec):
                self.tied_specs.setdefault(spec.key, []).append(i)

    # -- partitioning ----------------------------------------------------
    def _count_layer_params(self, idx):
        """A layer's weight for the 'parameters' balancer: its class's
        ``param_count`` when it declares one, else its parameters' numel
        (the JAX module's counts once its parameters exist)."""
        layer = self._built[idx]
        if hasattr(layer, "param_count"):
            return int(layer.param_count)
        if isinstance(layer, nn.Module):
            return sum(p.numel() for p in layer.parameters())
        return 0

    def _partition_layers(self, method):
        num_stages = self.num_stages
        method = method.lower()
        if method == "uniform":
            parts = partition_uniform(self._num_layers, num_stages)
        elif method == "parameters":
            weights = [self._count_layer_params(i) for i in range(self._num_layers)]
            parts = partition_balanced(weights, num_stages)
        elif method.startswith("type:"):
            layertype = method.split(":", 1)[1]
            binary_weights = [
                1 if re.search(layertype, self._built[i].__class__.__name__, re.IGNORECASE) else 0
                for i in range(self._num_layers)]
            parts = partition_balanced(binary_weights, num_stages)
        elif method == "profile":
            raise NotImplementedError("partition_method='profile' is not implemented")
        else:
            raise NotImplementedError(f"Partitioning method {method} not implemented.")
        assert len(parts) == num_stages + 1
        return parts

    def stage_layer_range(self, stage_id):
        return self.parts[stage_id], self.parts[stage_id + 1]

    def interleave_virtual_stages(self, num_model_chunks):
        """Re-partition into ``S * V`` virtual stages for interleaved 1F1B:
        virtual stage ``p = chunk * S + rank`` owns the p-th of ``S * V``
        contiguous layer slices, so rank r holds slices r, S + r, 2S + r,
        ... Idempotent per V."""
        V = int(num_model_chunks)
        if V <= 1 or getattr(self, "_virtual_chunks", 1) == V:
            return
        assert getattr(self, "_virtual_chunks", 1) == 1, \
            "interleave_virtual_stages called twice with different V"
        phys = self.num_stages
        if self._num_layers < phys * V:
            raise ValueError(
                f"num_model_chunks={V}: cannot split {self._num_layers} layers "
                f"into {phys * V} virtual stages (need >= 1 layer per stage)")
        self._virtual_chunks = V
        self.num_stages = phys * V
        self.parts = self._partition_layers(self._partition_method)

    # -- parameters ------------------------------------------------------
    def _layer_generator(self, idx, device):
        if self.seed_fn is not None:
            return self.seed_fn(self.base_seed + idx)
        return torch.Generator(device=device).manual_seed(self.base_seed + idx)

    def load_jax_params(self, layers):
        """Take a JAX ``PipelineModule``'s per-layer parameter trees (numpy
        arrays, from ``PipelineEngine._gather_layer_params()`` or flax
        init; ``None`` for a stateless layer) as the initial weights in
        place of the draws. Each module layer converts its tree with its
        ``jax_state_dict(tree)``. Call before ``initialize()``."""
        if self._materialized:
            raise RuntimeError("load_jax_params must be called before initialize() "
                               "places the layers")
        if len(layers) != self._num_layers:
            raise ValueError(f"{len(layers)} parameter trees for {self._num_layers} layers")
        for i, tree in enumerate(layers):
            layer = self._built[i]
            if tree is None or not isinstance(layer, nn.Module) or \
                    not any(True for _ in layer.parameters()):
                continue
            if not hasattr(layer, "jax_state_dict"):
                raise TypeError(f"layer {i} ({type(layer).__name__}) has no "
                                "jax_state_dict(tree) to convert a flax tree")
            self._jax_states[i] = layer.jax_state_dict(tree)

    def init_params(self, device_of_layer):
        """Give every module layer storage on ``device_of_layer(index)`` and
        its initial fp32 weights (once)."""
        if self._materialized:
            return
        owners = {}
        for i, layer in enumerate(self._built):
            if not isinstance(layer, nn.Module):
                continue
            device = torch.device(device_of_layer(i))
            spec = self._layer_specs[i]
            key = spec.key if isinstance(spec, TiedLayerSpec) else None
            if not self._from_spec[i]:
                layer.to(device)
            else:
                layer.to_empty(device=device)
                with torch.no_grad():
                    if i in self._jax_states:
                        layer.load_state_dict(
                            {k: torch.as_tensor(v) for k, v in self._jax_states[i].items()},
                            strict=True)
                    elif key is not None and key in owners:
                        for p, q in zip(layer.parameters(), owners[key].parameters()):
                            p.copy_(q)
                    elif hasattr(layer, "init_weights"):
                        layer.init_weights(self._layer_generator(i, device))
                    else:
                        default_init(layer, self._layer_generator(i, device))
            if key is not None:
                owners.setdefault(key, layer)
        self._jax_states = {}
        self._materialized = True

    def shard_layers(self, mesh):
        """Tensor parallelism inside every stage: Megatron layers in place
        of each layer's matched linears and embeddings (``tp.shard_params``
        under the mesh's model axis), after the weights are drawn, so a
        layer keeps the weights its ``base_seed + index`` generator drew
        at tensor_parallel 1. A no-op at model size 1."""
        from deepspeed_tpu_torch.parallel import tp

        for layer in self._built:
            if isinstance(layer, nn.Module):
                tp.shard_params(layer, mesh)

    # -- forward ---------------------------------------------------------
    def apply_layer(self, idx, x, dropout_seed=None, deterministic=None):
        """Layer ``idx`` on ``x`` (a tensor or a tuple of inputs). A layer
        whose forward takes ``dropout_seed`` gets ``dropout_seed`` folded
        with its index; one that takes ``deterministic`` gets the flag
        when it is given."""
        layer = self._built[idx]
        spec = self._layer_specs[idx]
        inputs = x if isinstance(x, tuple) else (x,)
        if isinstance(spec, TiedLayerSpec) and spec.forward_fn is not None:
            return spec.forward_fn(layer, *inputs)
        kwargs = {}
        takes_seed, takes_flag = self._takes[idx]
        if dropout_seed is not None and takes_seed:
            kwargs["dropout_seed"] = fold_seed(dropout_seed, idx)
        if deterministic is not None and takes_flag:
            kwargs["deterministic"] = deterministic
        return layer(*inputs, **kwargs)

    def stage_forward(self, stage_id, x, dropout_seed=None, deterministic=None):
        """Stage ``stage_id``'s layers on ``x``, one after the other."""
        start, end = self.stage_layer_range(stage_id)
        for idx in range(start, end):
            x = self.apply_layer(idx, x, dropout_seed=dropout_seed, deterministic=deterministic)
        return x

    def forward(self, x, dropout_seed=None, deterministic=None):
        """Whole-model forward (every layer in order)."""
        for idx in range(self._num_layers):
            x = self.apply_layer(idx, x, dropout_seed=dropout_seed, deterministic=deterministic)
        return x

    # -- accessors -------------------------------------------------------
    def topology(self):
        return self._topo

    def mpu(self):
        return PipelineParallelGrid(topology=self._topo)

    def num_pipeline_stages(self):
        return self.num_stages

    def get_layers(self):
        return self._built

    def describe_partitions(self):
        lines = []
        for s in range(self.num_stages):
            lo, hi = self.stage_layer_range(s)
            names = [self._built[i].__class__.__name__ for i in range(lo, hi)]
            lines.append(f"stage {s}: layers [{lo}, {hi}) {names}")
        return "\n".join(lines)
