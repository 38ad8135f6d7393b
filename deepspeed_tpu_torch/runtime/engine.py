"""DeepSpeedEngine: data-parallel training of a PyTorch module.

Port of ``deepspeed_tpu/runtime/engine.py`` for the path
``initialize()`` -> ``train_step`` / ``train_batch`` (and the three-call
``forward`` / ``backward`` / ``step``), one process a card:

- mixed precision as the JAX engine does it: the engine holds fp32
  master parameters and fp32 optimizer state, and the module's weights
  are the compute-dtype (bf16 or fp16) copy that every forward runs on,
  so LayerNorm and softmax inputs are in that dtype as in JAX (no
  ``torch.autocast``);
- fp16 with static or dynamic loss scaling: the loss is multiplied by
  the scale before backward, the accumulated gradients are checked for
  inf / nan (the fp16 step's one host read), an overflowing step is
  skipped (grad norm -1, the LR schedule held) and the scaler backs off;
  the scaler's state lives on the device. bf16 and fp32 steps read
  nothing on the host;
- the optimizers Adam/AdamW, LAMB and SGD, an LR schedule from the
  config (or ``lr_scheduler=``) whose LR feeds every update, and the
  engine's own ``DeepSpeedDataLoader`` over ``training_data=``;
- gradient accumulation over ``gradient_accumulation_steps`` into fp32
  buffers, with the JAX engine's factor (1/gas, or 1/(gas * predivide)
  under ``prescale_gradients``);
- the shared update: global norm or clipping, then the optimizer on the
  masters, then the masters cast back into the module;
- the ``activation_checkpointing`` section configures
  ``checkpointing`` and flips the model config's
  ``checkpoint_activations`` (per-layer recompute), with
  ``cpu_checkpointing`` also its ``checkpoint_policy`` to
  ``offload_dots`` (the saved matmul outputs in pinned host memory); a
  model without that switch has its whole forward recomputed (under
  ``offload_dots`` with ``cpu_checkpointing``);
- the monitors (``tensorboard``, ``csv_monitor``, and the telemetry
  registry when the ``telemetry`` block arms it): the JAX engine's
  ``Train/Samples/*`` records a step, kept as device tensors and written
  at every ``steps_per_print``-th step's flush and at ``close()``; under
  ``wall_clock_breakdown`` the forward / backward / step microstep timers
  (each waits for the card) are logged every ``steps_per_print`` steps,
  with the card's allocated and peak memory under ``memory_breakdown``;
- the FLOPS profiler (``flops_profiler``): at ``profile_step`` the first
  microbatch's forward through backward is timed with the card
  synchronised at both ends, then counted in a separate pass under
  ``FlopCounterMode`` (its random streams put back, its gradients
  dropped), the report printed and ``Train/Samples/model_tflops`` and
  ``mfu`` recorded; the fused ``train_step`` refuses an armed profiler,
  and ``train_batch`` then runs the three calls;
- the sentinels (``jax_sentinels``): ``train_step`` records its programs
  (distinct microbatch signatures) under a ``CompileSentinel`` budget, and
  with ``transfer_guard`` its forward, backward and update run inside
  ``transfer_free()`` (the fp16 overflow verdict is read through the
  sanctioned ``device_get``);
- one explicit step ``torch.Generator`` seeded from the config ``seed``
  (default 42) hands every microbatch one integer dropout seed;
- ``initialize`` starts the ``torch.distributed`` group from the
  launcher's environment (``utils/distributed.py``) and lays the ranks out
  as the (pipe, data, model) mesh (``parallel/mesh.py``): the world split
  by ``tensor_parallel.size`` (``mesh.data_parallel_size`` must cover the
  world with it), or an external ``mpu``'s groups. At ZeRO stage 0 with
  more than one data rank the accumulated gradients are all-reduced to
  their mean over the data group before the update; the loader, the tag
  validation and the save take the data group too;
- tensor parallelism (``tensor_parallel.size`` > 1): ``parallel/tp.py``
  puts Megatron column / row / vocab-parallel layers in place of the
  modules JAX's rules shard, each rank holding its shards as the
  parameters; the norm sums the shards over the model group and the fp16
  overflow flag is a MAX over it; ZeRO stages 1-2 then run per parameter
  (``ZeroPytreeOptimizer``), ZeRO-3 is refused; a tag holds whole tensors,
  so it loads at any tensor-parallel size;
- 1-bit Adam (``optimizer onebitadam``) at more than one data rank without
  ZeRO or tensor parallelism steps through ``OnebitStep``: dense warm-up,
  then the sign-compressed momentum all-reduce;
- ZeRO stages 1-3 and ZeRO-Offload through ``runtime/zero``
  (``ZeroShardedOptimizer``): the fp16 overflow verdict and the gradient
  norm are then reduced over the ranks (MAX, and a SUM of squares), and
  under ``cpu_offload`` Adam runs on the host (``DeepSpeedCPUAdam``);
- ``save_checkpoint`` / ``load_checkpoint`` through ``runtime/checkpoint``
  (atomic files, a manifest as the commit record, rotation, retries, and
  on load a loud fall-back to the newest committed tag), with the JAX
  engine's file names and the state a tag holds: each rank writes its
  ZeRO shard, and a load at another dp degree re-partitions the shards
  (with ``elasticity``, re-splitting the preserved global batch);
- the ``telemetry`` block arms the process-global tracer (the JAX
  engine's span names on the same calls), the introspection endpoint
  and the SLO rules, evaluated once a ``train_batch``;
- the ``resilience`` block runs ``train_batch`` under the
  ``runtime/resilience`` supervisor (divergence guard, watchdog, rollback
  to the newest committed tag and replay); at every step boundary the
  job-level hooks beat the worker supervisor's heartbeat, gossip health,
  fire the cluster fault arms and honour a preemption; the checkpoint
  commit barrier is deadline-bounded (``resilience.comm_timeout_s``).
"""

import contextlib
import dataclasses
import hashlib
import inspect
import io
import os
import time
import weakref

import torch

from deepspeed_tpu_torch import comm, telemetry
from deepspeed_tpu_torch.elasticity import compute_elastic_resume
from deepspeed_tpu_torch.models.gpt2 import resolve_device
from deepspeed_tpu_torch.ops.adam.cpu_adam import DeepSpeedCPUAdam
from deepspeed_tpu_torch.ops.adam.fused_adam import FusedAdam
from deepspeed_tpu_torch.ops.utils_op import flatten_dense_tensors, unflatten_dense_tensors
from deepspeed_tpu_torch.ops.lamb.fused_lamb import FusedLamb
from deepspeed_tpu_torch.ops.sgd import SGD
from deepspeed_tpu_torch.ops.sparse_attention import sparsity_config_from_dict
from deepspeed_tpu_torch.parallel import tp
from deepspeed_tpu_torch.parallel.expert import MoELayer
from deepspeed_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh, create_mesh
from deepspeed_tpu_torch.parallel.tp import local_part, whole_of
from deepspeed_tpu_torch.monitor import monitor_from_config
from deepspeed_tpu_torch.profiling.flops_profiler import FlopsProfiler
from deepspeed_tpu_torch.profiling.sentinels import (
    CompileSentinel,
    device_get,
    records_programs,
    register_allowed_transfer,
    transfer_free,
)
from deepspeed_tpu_torch.runtime.activation_checkpointing import checkpointing
from deepspeed_tpu_torch.runtime.activation_checkpointing.checkpointing import (
    checkpoint_call,
)
from deepspeed_tpu_torch.runtime.checkpoint import (
    CheckpointCorruptionError,
    CheckpointStorage,
)
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.runtime.config_utils import resolve_dp_size, resolve_tp_size
from deepspeed_tpu_torch.runtime.constants import (
    ADAM_OPTIMIZER,
    ADAMW_OPTIMIZER,
    LAMB_OPTIMIZER,
    MAX_GRAD_NORM,
    ONEBIT_ADAM_OPTIMIZER,
    SGD_OPTIMIZER,
)
from deepspeed_tpu_torch.runtime.dataloader import DeepSpeedDataLoader
from deepspeed_tpu_torch.runtime.fp16.loss_scaler import (
    DynamicScalerState,
    advance_scaler,
    init_dynamic_scaler_state,
)
from deepspeed_tpu_torch.runtime.lr_schedules import get_lr_schedule
from deepspeed_tpu_torch.runtime.progressive_layer_drop import ProgressiveLayerDrop
from deepspeed_tpu_torch.runtime.resilience import ClusterHooks, ResilienceSupervisor
from deepspeed_tpu_torch.runtime.utils import clip_grad_norm_, global_norm, has_overflow
from deepspeed_tpu_torch.runtime.fp16.onebit_adam import OnebitAdam
from deepspeed_tpu_torch.runtime.zero.pytree_optimizer import ZeroPytreeOptimizer
from deepspeed_tpu_torch.runtime.zero.sharded_optimizer import ZeroShardedOptimizer
from deepspeed_tpu_torch.utils import distributed as dist
from deepspeed_tpu_torch.utils.logging import log_dist, logger
from deepspeed_tpu_torch.utils.timer import SynchronizedWallClockTimer, ThroughputTimer
from deepspeed_tpu_torch.version import __version__

ROUTE_TRAIN = "train"
# the fp16 step's one host read: the overflow verdict
_OVERFLOW_READ = register_allowed_transfer("train/overflow_read")
ZERO_SUPPORTED_OPTIMIZERS = [ADAM_OPTIMIZER, ADAMW_OPTIMIZER, LAMB_OPTIMIZER]
_NULL_SPAN = telemetry.NULL_SPAN
# the keys of a tag's module file that are the engine's own; the rest is
# the caller's client_state
DEEPSPEED_STATES = (
    "module", "optimizer", "lr_scheduler", "scaler", "step_rng", "pld_rng", "param_shapes",
    "skipped_steps", "global_steps", "global_samples", "dp_world_size", "mp_world_size",
    "train_batch_size",
)


def _host_tree(obj):
    """``obj`` with every tensor on the host and owning its storage: a
    device tensor or a view is copied (a view would save its whole
    storage), a CPU tensor of its own is kept."""
    if isinstance(obj, torch.Tensor):
        t = obj.detach()
        own = t.device.type == "cpu" and t.is_contiguous() and t.storage_offset() == 0 \
            and t.untyped_storage().nbytes() == t.numel() * t.element_size()
        return t if own else t.to("cpu", copy=True)
    if isinstance(obj, dict):
        return type(obj)((k, _host_tree(v)) for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host_tree(v) for v in obj)
    return obj


def _serialize(obj):
    buf = io.BytesIO()
    torch.save(obj, buf)
    return buf.getvalue()


def _deserialize(data, name):
    """Unpickle a verified checkpoint file with ``weights_only=True``:
    tensors, numbers, strings and the builtin containers, which is all the
    engine writes; anything else (or a torn file without a manifest) is a
    named error."""
    try:
        return torch.load(io.BytesIO(data), map_location="cpu", weights_only=True)
    except Exception as e:  # noqa: BLE001 -- a named error instead
        raise CheckpointCorruptionError(
            f"checkpoint file '{name}' does not unpickle ({type(e).__name__}: {e})")


def _state_dict_of(state):
    """An optimizer state dataclass as a dict of its fields."""
    return {f.name: getattr(state, f.name) for f in dataclasses.fields(state)}


def _load_state_into(state, saved):
    """Copy ``saved`` (from ``_state_dict_of``) into ``state`` in place."""
    with torch.no_grad():
        for name, value in saved.items():
            cur = getattr(state, name)
            if isinstance(cur, list):
                torch._foreach_copy_(cur, [v.to(c.device) for c, v in zip(cur, value)])
            else:
                setattr(state, name, type(cur)(value))


class ReplicatedOptimizer:
    """ZeRO stage 0's side of the engine's step, with the ZeRO optimizer's
    interface: every data rank holds the whole fp32 master and optimizer
    state (of its model-axis shards under tensor parallelism). The
    accumulated gradients become their mean over the data group (one
    all-reduce of their flat concatenation, skipped at one data rank), the
    inner optimizer steps the master a tensor at a time, and the master is
    cast into the module's compute-dtype parameters. Under tensor
    parallelism the norm sums the model-axis shards over the model group
    and counts the replicated tensors once, and the overflow flag is a MAX
    over the model group.

    Expert parallelism (``experts``: {parameter index: the group its
    ``MoELayer`` splits the experts over}): an expert's gradient is summed
    over the ranks that hold the same experts (``expert_data_group``, None
    when the experts split over the whole data group) and scaled by 1 /
    the data size, since each rank's expert already took every rank's
    tokens through the all-to-all; the norm counts each expert once (its
    squares summed over the expert group), and whole tensors gather the
    experts over it."""

    def __init__(self, inner, master, params, names, compute_dtype, mesh=None, tp_place=None,
                 experts=None, expert_data_group=None):
        self.inner = inner
        self.master = master
        self.params = params
        self.names = names
        self.cast = compute_dtype != torch.float32
        self.state = None
        if mesh is None:
            self.data_group = torch.distributed.group.WORLD \
                if dist.group_rank_and_size()[1] > 1 else None
            self.model_group = None
        else:
            self.data_group, self.model_group = mesh.group(DATA_AXIS), mesh.group(MODEL_AXIS)
        self.mp_rank = 0 if mesh is None else mesh.rank(MODEL_AXIS)
        self.world = comm.group_size(self.data_group)
        self.tp = [(tp_place or {}).get(n) for n in names]
        self.experts = dict(experts or {})
        self.expert_data_group = expert_data_group
        self.acc_grads = [torch.zeros_like(m) for m in master]

    @staticmethod
    def _mean_over(tensors, group, n):
        """``tensors`` (in place) summed over ``group`` and divided by ``n``:
        one all-reduce of their flat concatenation."""
        if not tensors or (comm.group_size(group) == 1 and n == 1):
            return
        flat = comm.all_reduce(flatten_dense_tensors(tensors), group)
        flat.div_(n)
        torch._foreach_copy_(tensors, unflatten_dense_tensors(
            flat, [tuple(g.shape) for g in tensors]))

    def reduce_gradients(self):
        if self.world > 1:
            acc = self.acc_grads
            self._mean_over([g for i, g in enumerate(acc) if i not in self.experts],
                            self.data_group, self.world)
            self._mean_over([g for i, g in enumerate(acc) if i in self.experts],
                            self.expert_data_group, self.world)
        return self.acc_grads

    def has_overflow(self, grads):
        # the reduced gradients are alike on every data rank, but experts
        flag = has_overflow(grads)
        if self.experts:
            flag = comm.all_reduce(flag.float(), self.data_group, comm.ReduceOp.MAX) > 0
        if self.model_group is None:
            return flag
        return comm.all_reduce(flag.float(), self.model_group, comm.ReduceOp.MAX) > 0

    def global_norm(self, grads):
        if self.experts:
            dense = [g for i, g in enumerate(grads) if i not in self.experts]
            sq = global_norm(dense) ** 2 if dense else torch.zeros((), device=grads[0].device)
            for group in {id(g): g for g in self.experts.values()}.values():
                mine = [grads[i] for i, eg in self.experts.items() if eg is group]
                sq = sq + comm.all_reduce(global_norm(mine) ** 2, group)
            return torch.sqrt(sq)
        if self.model_group is None:
            return global_norm(grads)
        split = [g for g, t in zip(grads, self.tp) if t is not None]
        whole = [g for g, t in zip(grads, self.tp) if t is None]
        sq = lambda ts: global_norm(ts).to(grads[0].device) ** 2 if ts else 0.0
        return torch.sqrt(comm.all_reduce(sq(split) + torch.zeros((), device=grads[0].device),
                                          self.model_group) + sq(whole))

    def update(self, grads, lr=None):
        with torch.no_grad():
            self.ensure_state()
            self.inner.update(grads, self.state, self.master, lr=lr, names=self.names)
            if self.cast:
                torch._foreach_copy_([p.data for p in self.params], self.master)

    def zero_grad(self):
        with torch.no_grad():
            torch._foreach_zero_(self.acc_grads)

    def ensure_state(self):
        if self.state is None:
            self.state = self.inner.init(self.master)
        return self.state

    def _whole(self, t, i):
        if i in self.experts:
            return comm.all_gather(t, self.experts[i], axis=0)
        if self.tp[i] is None:
            return t
        return whole_of(t, self.tp[i][0], self.model_group, self.tp[i][1])

    def _part(self, t, i):
        if i in self.experts:
            g = self.experts[i]
            return local_part(t, 0, comm.group_rank(g), comm.group_size(g))
        if self.tp[i] is None:
            return t
        return local_part(t, self.tp[i][0], self.mp_rank, comm.group_size(self.model_group),
                          self.tp[i][1])

    def master_params(self):
        """The whole fp32 masters (gathered over the model group)."""
        return [self._whole(m, i) for i, m in enumerate(self.master)]

    def load_master_params(self, values):
        """Copy whole fp32 values into the masters in place (this rank's
        model-axis part) and cast them into the module's parameters as the
        step does."""
        with torch.no_grad():
            torch._foreach_copy_(self.master, [self._part(v.to(m.device), i) for i, (m, v) in
                                               enumerate(zip(self.master, values))])
            if self.cast:
                torch._foreach_copy_([p.data for p in self.params], self.master)

    def whole_state(self):
        """The optimizer state with whole tensors."""
        state = self.ensure_state()
        out = _state_dict_of(state)
        for k, v in out.items():
            if isinstance(v, list) and len(v) == len(self.master):
                out[k] = [self._whole(t, i) for i, t in enumerate(v)]
        return out

    def load_whole_state(self, saved):
        state = self.ensure_state()
        saved = {k: ([self._part(t, i) for i, t in enumerate(v)]
                     if isinstance(v, list) and len(v) == len(self.master) else v)
                 for k, v in saved.items()}
        _load_state_into(state, saved)


class OnebitStep:
    """The engine's step under 1-bit Adam at more than one data rank (JAX's
    ``_get_onebit_step_fn``): this rank's accumulated gradients, not
    averaged, flatten into one fp32 vector (padded so every rank's segment
    packs to whole bytes) and ``OnebitAdam.update_flat`` steps the flat
    master, averaging the gradient densely in warm-up and the momentum
    through ``compressed_allreduce`` once frozen. The fp16 overflow verdict
    is a MAX over the data group; clipping (warm-up only) happens inside
    ``update_flat`` against the averaged gradient's norm."""

    def __init__(self, inner, master, params, compute_dtype, group):
        self.inner, self.master, self.params = inner, master, params
        self.cast = compute_dtype != torch.float32
        self.group = group
        self.world = comm.group_size(group)
        self.shapes = [tuple(m.shape) for m in master]
        self.numel = sum(m.numel() for m in master)
        self.n_pad = inner.padded_numel(self.numel, self.world)
        self.flat = torch.zeros(self.n_pad, dtype=torch.float32, device=master[0].device)
        self.flat[:self.numel].copy_(flatten_dense_tensors(master))
        self.state = None
        self.acc_grads = [torch.zeros_like(m) for m in master]

    def reduce_gradients(self):
        return self.acc_grads       # the compressed step reduces them itself

    def has_overflow(self, grads):
        return comm.all_reduce(has_overflow(grads).float(), self.group, comm.ReduceOp.MAX) > 0

    def ensure_state(self):
        if self.state is None:
            self.state = self.inner.init_flat(self.n_pad, self.world, self.flat.device)
        return self.state

    def step(self, grads, lr, clip):
        """The whole 1-bit step; returns the norm ``update_flat`` reports."""
        with torch.no_grad():
            g = torch.zeros_like(self.flat)
            g[:self.numel].copy_(flatten_dense_tensors(grads))
            gnorm = self.inner.update_flat(g, self.ensure_state(), self.flat, self.group,
                                           lr=lr, clip=clip)
            torch._foreach_copy_(self.master, unflatten_dense_tensors(self.flat, self.shapes))
            if self.cast:
                torch._foreach_copy_([p.data for p in self.params], self.master)
        return gnorm

    def zero_grad(self):
        with torch.no_grad():
            torch._foreach_zero_(self.acc_grads)

    def master_params(self):
        return list(self.master)

    def load_master_params(self, values):
        with torch.no_grad():
            torch._foreach_copy_(self.master, [v.to(m.device) for m, v in
                                               zip(self.master, values)])
            self.flat[:self.numel].copy_(flatten_dense_tensors(self.master))
            if self.cast:
                torch._foreach_copy_([p.data for p in self.params], self.master)

    def whole_state(self):
        return _state_dict_of(self.ensure_state())

    def load_whole_state(self, saved):
        state = self.ensure_state()
        for k, v in saved.items():
            setattr(state, k, v.to(self.flat.device) if torch.is_tensor(v) else v)


def _expert_data_group(ep_group, data_group):
    """The group of the data ranks holding this rank's experts: those at
    this rank's position in their own expert group (a collective of the
    data group; None when the expert group spans the data group)."""
    dp, W = comm.group_size(data_group), comm.group_size(ep_group)
    assert dp % W == 0, f"the expert group ({W} ranks) does not split the data group ({dp})"
    if W == dp:
        return None
    mine = (comm.group_rank(ep_group), torch.distributed.get_rank())
    every = [None] * dp
    torch.distributed.all_gather_object(every, mine, group=data_group)
    out = None
    for pos in range(W):   # every rank makes every group, in one order
        ranks = sorted(r for p, r in every if p == pos)
        g = torch.distributed.new_group(ranks)
        if pos == mine[0]:
            out = g
    return out


def configure_mesh(config, mpu):
    """The (pipe, data, model) mesh: an external ``mpu``'s groups, or the
    world split by ``tensor_parallel.size`` (and an explicit
    ``mesh.data_parallel_size``, which must cover the world with it: one
    process a rank, so the launcher sizes the world)."""
    mp_size = resolve_tp_size(config, mpu)
    if mpu is not None:
        mesh = Mesh.from_mpu(mpu)
        assert mesh.shape[MODEL_AXIS] == mp_size, (
            f"mpu reports model parallel {mesh.shape[MODEL_AXIS]}, config {mp_size}")
        return mesh
    dp_size = resolve_dp_size(config)
    world = dist.get_world_size()
    if dp_size is not None and dp_size * mp_size != world:
        raise ValueError(
            f"mesh.data_parallel_size={dp_size} x tensor_parallel={mp_size} must equal "
            f"the world size {world}: one process a rank, the launcher sizes the world")
    return create_mesh(data_parallel_size=dp_size, model_parallel_size=mp_size)


class DeepSpeedEngine:
    """Wraps a module for mixed-precision, data-parallel training."""

    def __init__(self, args=None, model=None, optimizer=None, model_parameters=None,
                 training_data=None, lr_scheduler=None, mpu=None,
                 dist_init_required=None, collate_fn=None, config=None,
                 config_params=None, device="cuda"):
        if model is None:
            raise ValueError("deepspeed_tpu_torch.initialize requires a model")
        if not isinstance(model, torch.nn.Module):
            raise TypeError("model must be a torch.nn.Module")
        if config is None and args is not None:
            config = getattr(args, "deepspeed_config", None)
        if config is None:
            config = config_params
        assert config is not None, "DeepSpeed requires a config (config= or config_params=)"

        if dist_init_required is None or dist_init_required:
            dist.init_distributed(verbose=False, device_type=torch.device(device).type)
        self.device = resolve_device(device)
        self.mesh = configure_mesh(config, mpu)
        self.mpu = mpu
        self.dp_world_size = self.mesh.shape[DATA_AXIS]
        self.mp_world_size = self.mesh.shape[MODEL_AXIS]
        self._config = DeepSpeedConfig(config, world_size=self.dp_world_size)
        self.global_rank = dist.get_rank()
        self.loaded_checkpoint_dp_world_size = None
        self.client_optimizer = optimizer
        self.global_steps = 0
        self.global_samples = 0
        self.micro_steps = 0
        self.skipped_steps = 0
        self.training = True
        self.lr_scheduler = None
        self.training_data = training_data
        self.collate_fn = collate_fn

        if self._config.fp16_enabled:
            self.compute_dtype = torch.float16
        elif self._config.bfloat16_enabled:
            self.compute_dtype = torch.bfloat16
        else:
            self.compute_dtype = torch.float32

        # --- model: fp32 masters held by the engine, compute-dtype weights
        # in the module
        self.module = model.to(self.device)
        self._zero3 = self.zero_optimization() and self.zero_optimization_stage() >= 3
        self._pytree_zero = self.zero_optimization() and self.mp_world_size > 1
        if self.mp_world_size > 1:
            assert not self._zero3, (
                "ZeRO-3 with tensor parallelism is not supported yet: TP already shards "
                "params along the model axis; use stage <= 2")
            # Megatron layers in place of the matched modules, each holding
            # its model-axis shard
            tp.shard_params(self.module, self.mesh)
        self._tp_place = tp.sharded_params(self.module)
        named = [(n, p) for n, p in self.module.named_parameters() if p.requires_grad]
        self._expert_groups = self._configure_experts(optimizer)
        if model_parameters is not None:
            chosen = {id(p) for p in model_parameters}
            named = [(n, p) for n, p in named if id(p) in chosen]
        self._param_names = [n for n, _ in named]
        self._params = [p for _, p in named]
        self._onebit = self._onebit_path(optimizer)
        if self.zero_optimization() and not self._pytree_zero:
            # the ZeRO optimizer takes the fp32 values as its master and
            # rebinds the parameters to its flat compute-dtype buffer
            for p in self._params:
                p.data = p.data.float()
            self._master = None
            chosen = {id(p) for p in self._params}
            for t in [p for p in self.module.parameters() if id(p) not in chosen] + \
                    list(self.module.buffers()):
                if t.is_floating_point():
                    t.data = t.data.to(self.compute_dtype)
        elif self.compute_dtype == torch.float32:
            for p in self._params:
                p.data = p.data.float()
            self._master = [p.data for p in self._params]   # updated in place
        else:
            self._master = [p.detach().float().clone() for p in self._params]
            self.module.to(self.compute_dtype)
        self._grads_in_hooks = False

        self._configure_activation_checkpointing()

        self.timers = SynchronizedWallClockTimer(device=self.device)
        self.tput_timer = ThroughputTimer(
            batch_size=self.train_micro_batch_size_per_gpu(), num_workers=1,
            steps_per_output=self.steps_per_print(),
            logging_fn=lambda msg: log_dist(msg, ranks=[0]))
        self.training_dataloader = (self.deepspeed_io(training_data)
                                    if training_data is not None else None)

        self._configure_optimizer(optimizer)
        self._configure_lr_scheduler(lr_scheduler)
        self._configure_loss_scaler()
        self._step_gen = torch.Generator().manual_seed(int(self._config.seed))
        # progressive layer drop: the coins' seeds come from a stream of
        # their own, so the dropout seeds (and theta = 1) are untouched
        self.progressive_layer_drop = None
        if self.pld_enabled():
            self.progressive_layer_drop = ProgressiveLayerDrop(
                theta=self.pld_theta(), gamma=self.pld_gamma())
        self._pld_gen = torch.Generator().manual_seed(int(self._config.seed) ^ 0x1D)
        self.last_grad_norm = None
        self._last_overflow = False
        me = weakref.proxy(self)
        self._configure_profiling(me)
        self._configure_telemetry()
        # the monitors, after the telemetry block so that the registry's
        # bridge rides along when it is armed; the step's mean loss is kept
        # as a device tensor until a flush
        self.monitor = monitor_from_config(self._config, self.global_rank)
        self._last_loss = None
        self._loss_sum = None
        self._timer_prev = {}
        # both reach the engine through a weak proxy: the engine owns them,
        # and a reference cycle would keep a dropped engine's device memory
        # until the next garbage collection
        # step-level resilience: divergence guard, watchdog and rollback
        # recovery (None without a `resilience` block)
        self.resilience = ResilienceSupervisor.from_ds_config(self._config, me)
        # job-level hooks at every step boundary: the worker supervisor's
        # heartbeat, preemption, health gossip, cluster fault arms (no-ops
        # unless configured or run under a supervisor). Built here, on the
        # caller's thread: Python installs signal handlers only on the main
        # thread, and a supervised step may run on a watchdog thread.
        self._cluster = ClusterHooks(me)
        self._config.print("DeepSpeedEngine configuration")

    def _configure_profiling(self, me):
        """The FLOPS profiler and the sentinels. ``train_step`` records its
        programs through a closure over the weak proxy ``me``, so the
        recorder holds no reference cycle to the engine."""
        self.flops_profiler = FlopsProfiler() if self._config.flops_profiler_config.enabled \
            else None
        self._profile_batch = None
        self._flops_gauges = None
        self.last_profile = None        # the profiled microbatch's numbers and report

        def train_step(microbatches):
            return me._fused_train_step(microbatches)

        self._train_step_programs = records_programs(train_step)
        sent = self._config.sentinel_config
        self._train_step_sentinel = (
            CompileSentinel(self._train_step_programs, sent.compile_budget,
                            name="fused train_step") if sent.enabled else None)
        self._transfer_guard = bool(sent.enabled and sent.transfer_guard)
        if self._transfer_guard and self.wall_clock_breakdown():
            raise ValueError("jax_sentinels.transfer_guard with wall_clock_breakdown: the "
                             "breakdown's timers wait for the card inside the guarded step")

    def _configure_experts(self, client_optimizer):
        """{parameter name: its expert group} of the expert-parallel
        ``MoELayer``s' stacked experts, and ``self._expert_data_group``: the
        ranks of the data group holding the same experts (None when the
        experts split over the whole data group). ZeRO, 1-bit Adam and
        tensor parallelism with split experts are refused by name."""
        layers = [(n, m) for n, m in self.module.named_modules()
                  if isinstance(m, MoELayer) and comm.group_size(m.group) > 1]
        self._expert_data_group = None
        if not layers:
            return {}
        refused = [what for what, on in (
            ("ZeRO (zero_optimization.stage > 0)", self.zero_optimization()),
            ("tensor parallelism", self.mp_world_size > 1),
            ("OnebitAdam", (self.optimizer_name() or "").lower() == ONEBIT_ADAM_OPTIMIZER),
        ) if on]
        if refused:
            raise NotImplementedError(
                f"{', '.join(refused)} with an expert-parallel MoELayer under initialize() "
                "is not ported to deepspeed_tpu_torch yet (ROADMAP.md queue 1)")
        groups = {id(m.group): m.group for _, m in layers}
        if len(groups) > 1:
            raise NotImplementedError("expert-parallel MoELayers over different groups under "
                                      "one engine are not ported (ROADMAP.md queue 1)")
        ep = next(iter(groups.values()))
        self._expert_data_group = _expert_data_group(ep, self.mesh.group(DATA_AXIS))
        return {f"{n}.{k}" if n else k: ep for n, _ in layers for k in ("w1", "b1", "w2", "b2")}

    def _onebit_path(self, client_optimizer):
        """True when the step runs the 1-bit compressed collective (JAX's
        condition): OnebitAdam configured, more than one data rank, no
        ZeRO, no tensor parallelism, no client optimizer."""
        return ((self.optimizer_name() or "").lower() == ONEBIT_ADAM_OPTIMIZER
                and not self.zero_optimization() and self.dp_world_size > 1
                and self.mp_world_size == 1 and client_optimizer is None)

    def _configure_telemetry(self):
        """An explicit ``telemetry`` block arms the process-global tracer
        and registry (an absent block leaves them as they are); when it
        enables them, the endpoint binds ``http_port`` or the launcher's
        ``DSTPU_TELEMETRY_PORT`` with the ``train_loop`` health and
        ``train`` snapshot providers, and the SLO rules are checked once a
        ``train_batch``."""
        telemetry.configure_from_config(self._config.telemetry_config,
                                        rank=self.global_rank, role="train")
        self._tracer = telemetry.get_tracer()
        self.telemetry_server = None
        self._slo = None
        tel_cfg = self._config.telemetry_config
        if tel_cfg is not None and tel_cfg.enabled:
            http_port = telemetry.resolve_http_port(tel_cfg)
            if http_port is not None:
                srv = telemetry.TelemetryServer(
                    registry=telemetry.get_registry(), tracer=self._tracer, port=http_port)
                srv.add_health_provider(
                    "train_loop",
                    lambda: {"healthy": True, "steps": self.global_steps,
                             "skipped": self.skipped_steps})
                srv.add_snapshot_provider(
                    "train",
                    lambda: {"global_steps": self.global_steps,
                             "global_samples": self.global_samples,
                             "skipped_steps": self.skipped_steps})
                self.telemetry_server = srv.start()
            self._slo = telemetry.SloEngine.from_config(
                tel_cfg, tracer=self._tracer, registry=telemetry.get_registry())
            if self._slo is not None and self.telemetry_server is not None:
                self._slo.attach(self.telemetry_server)
        self._slo_registry = telemetry.get_registry()

    # ------------------------------------------------------------------
    # config accessors
    # ------------------------------------------------------------------
    def train_batch_size(self):
        return self._config.train_batch_size

    def train_micro_batch_size_per_gpu(self):
        return self._config.train_micro_batch_size_per_gpu

    def gradient_accumulation_steps(self):
        return self._config.gradient_accumulation_steps

    def steps_per_print(self):
        return self._config.steps_per_print

    def wall_clock_breakdown(self):
        return self._config.wall_clock_breakdown

    def memory_breakdown(self):
        return self._config.memory_breakdown

    def bfloat16_enabled(self):
        return self._config.bfloat16_enabled

    def fp16_enabled(self):
        return self._config.fp16_enabled

    def loss_scale(self):
        """The current loss scale as a host float (a host read under
        dynamic scaling); 1.0 without fp16."""
        if self.fp16_enabled():
            if self.dynamic_loss_scale():
                return float(self.scaler_state.cur_scale)
            return self._config.loss_scale
        return 1.0

    def dynamic_loss_scale(self):
        return self._config.loss_scale == 0 and self.fp16_enabled()

    def initial_dynamic_scale(self):
        return self._config.initial_dynamic_scale

    def dynamic_loss_scale_args(self):
        return self._config.dynamic_loss_scale_args

    def scheduler_name(self):
        return self._config.scheduler_name

    def scheduler_params(self):
        return self._config.scheduler_params

    def sparse_attention_config(self):
        """The parsed ``sparse_attention`` section (a mode-keyed dict) or
        None."""
        return self._config.sparse_attention

    def sparse_attention_sparsity_config(self, num_heads):
        """The configured sparsity as a ``SparsityConfig`` for
        ``SparseSelfAttention`` / ``BertSparseSelfAttention``; None when the
        config has no ``sparse_attention`` section."""
        if self._config.sparse_attention is None:
            return None
        return sparsity_config_from_dict(self._config.sparse_attention, num_heads)

    def gradient_clipping(self):
        return self._config.gradient_clipping

    def allreduce_always_fp32(self):
        return self._config.allreduce_always_fp32

    def optimizer_legacy_fusion(self):
        return self._config.optimizer_legacy_fusion

    def postscale_gradients(self):
        return not self._config.prescale_gradients

    def gradient_predivide_factor(self):
        return self._config.gradient_predivide_factor

    def optimizer_name(self):
        return self._config.optimizer_name

    def zero_optimization(self):
        return self._config.zero_enabled

    def zero_optimization_stage(self):
        return self._config.zero_optimization_stage

    def zero_cpu_offload(self):
        return self._config.zero_config.cpu_offload

    def zero_offload_stream_buckets(self):
        return self._config.zero_config.offload_stream_buckets

    def zero_offload_pin_host(self):
        return self._config.zero_config.offload_pin_host

    def zero_reduce_bucket_size(self):
        return self._config.zero_config.reduce_bucket_size

    def zero_allgather_bucket_size(self):
        return self._config.zero_config.allgather_bucket_size

    def zero_overlap_comm(self):
        return self._config.zero_config.overlap_comm

    def zero_reduce_scatter(self):
        return self._config.zero_config.reduce_scatter

    def zero_contiguous_gradients(self):
        return self._config.zero_config.contiguous_gradients

    def zero_elastic_checkpoint(self):
        return self._config.zero_config.elastic_checkpoint

    def optimizer_params(self):
        return self._config.optimizer_params

    def pld_enabled(self):
        return self._config.pld_enabled

    def pld_theta(self):
        return self._config.pld_theta

    def pld_gamma(self):
        return self._config.pld_gamma

    def elasticity_enabled(self):
        return self._config.elasticity_enabled

    def train(self, mode=True):
        self.training = mode

    def eval(self):
        self.training = False

    def _configure_optimizer(self, client_optimizer):
        """The optimizer from the config (or ``optimizer=``), wrapped in the
        ZeRO optimizer at stages 1-3, which then lays out the parameters."""
        if client_optimizer is not None:
            basic_optimizer = client_optimizer
            log_dist("Using client Optimizer as basic optimizer", ranks=[0])
        else:
            basic_optimizer = self._configure_basic_optimizer()
            log_dist(f"Using DeepSpeed Optimizer param name {self.optimizer_name()} as "
                     "basic optimizer", ranks=[0])
        self.basic_optimizer = basic_optimizer
        if self._onebit:
            self.optimizer = basic_optimizer
            self._step_optimizer = OnebitStep(basic_optimizer, self._master, self._params,
                                              self.compute_dtype, self.mesh.group(DATA_AXIS))
            self._acc_grads = self._step_optimizer.acc_grads
            return
        if not self.zero_optimization():
            self.optimizer = basic_optimizer
            experts = {i: self._expert_groups[n] for i, n in enumerate(self._param_names)
                       if n in self._expert_groups}
            self._step_optimizer = ReplicatedOptimizer(
                basic_optimizer, self._master, self._params, self._param_names,
                self.compute_dtype, mesh=self.mesh, tp_place=self._tp_place,
                experts=experts,
                expert_data_group=self._expert_data_group if experts else None)
            self._acc_grads = self._step_optimizer.acc_grads
            return
        if self.optimizer_name() is not None and \
                not self._is_supported_optimizer(self.optimizer_name()):
            assert self._config.zero_allow_untested_optimizer, (
                "You are using an untested ZeRO Optimizer. Please add "
                '"zero_allow_untested_optimizer": true in the DeepSpeed JSON config.')
            logger.warning("**** You are using ZeRO with an untested optimizer, proceeding "
                           "with caution ****")
        self.optimizer = self._step_optimizer = self._configure_zero_optimizer(basic_optimizer)

    def _is_supported_optimizer(self, name):
        return (name or "").lower() in ZERO_SUPPORTED_OPTIMIZERS or (
            self.client_optimizer is not None
            and getattr(self.client_optimizer, "name", "") in ZERO_SUPPORTED_OPTIMIZERS)

    def _configure_zero_optimizer(self, basic_optimizer):
        stage = self.zero_optimization_stage()
        if self._pytree_zero:
            # the flat vector would mix the model-axis shards; the
            # per-parameter variant keeps them apart
            log_dist(f"Creating ZeRO(pytree) stage {stage} optimizer "
                     f"(mp={self.mp_world_size})", ranks=[0])
            zero = ZeroPytreeOptimizer(
                basic_optimizer, stage=stage, mesh=self.mesh, cpu_offload=self.zero_cpu_offload(),
                offload_stream_buckets=self.zero_offload_stream_buckets(),
                offload_pin_host=self.zero_offload_pin_host())
            flips = {n: f for n, (_, _, f) in tp.flax_view(self.module).items()}
            zero.init(self._params, self._param_names, self._master, self._tp_place, flips)
            self._master = None
            self._acc_grads = zero.acc_grads
            return zero
        if self.zero_contiguous_gradients():
            log_dist("ZeRO: 'contiguous_gradients'=True is accepted for parity but is a "
                     "NO-OP: the gradients always accumulate into one flat buffer",
                     ranks=[0])
        log_dist(f"Creating ZeRO stage {stage} optimizer", ranks=[0])
        zero = ZeroShardedOptimizer(
            basic_optimizer, stage=stage, cpu_offload=self.zero_cpu_offload(),
            reduce_scatter=self.zero_reduce_scatter(),
            reduce_bucket_size=self.zero_reduce_bucket_size(),
            allgather_bucket_size=self.zero_allgather_bucket_size(),
            overlap_comm=self.zero_overlap_comm(),
            offload_stream_buckets=self.zero_offload_stream_buckets(),
            offload_pin_host=self.zero_offload_pin_host(),
            compute_dtype=self.compute_dtype,
            gradient_accumulation_steps=self.gradient_accumulation_steps())
        zero.init(self._params, self._param_names)
        self._acc_grads = zero.acc_grads
        self._grads_in_hooks = zero.register_overlap_hooks(self._accumulation_factor())
        return zero

    def _configure_basic_optimizer(self):
        name = self.optimizer_name()
        params = dict(self.optimizer_params() or {})
        params.pop(MAX_GRAD_NORM, None)
        if name is None:
            raise ValueError("'optimizer' was not specified in the config and no "
                             "optimizer instance was passed")
        name = name.lower()
        if name in (ADAM_OPTIMIZER, ADAMW_OPTIMIZER):
            if self.zero_cpu_offload():
                return DeepSpeedCPUAdam(adam_w_mode=(name == ADAMW_OPTIMIZER), **params)
            return FusedAdam(adam_w_mode=(name == ADAMW_OPTIMIZER), **params)
        if name == LAMB_OPTIMIZER:
            return FusedLamb(**params)
        if name == SGD_OPTIMIZER:
            return SGD(**params)
        if name == ONEBIT_ADAM_OPTIMIZER:
            return OnebitAdam(engine=self, **params)
        raise ValueError(f"Unknown optimizer name {name}")

    def _configure_lr_scheduler(self, client_lr_scheduler):
        name = self.scheduler_name()
        if name is not None:
            if client_lr_scheduler is not None:
                raise ValueError("Found both scheduler in config and lr_scheduler passed "
                                 "to initialize")
            self.lr_scheduler = get_lr_schedule(name, self.scheduler_params())
            log_dist(f"DeepSpeed using configured LR scheduler = {name}", ranks=[0])
        else:
            self.lr_scheduler = client_lr_scheduler
        # torch-style: the LR of step k is set at the end of step k - 1, so
        # prime the schedule once (a skipped step then leaves the LR as is)
        if self.lr_scheduler is not None and \
                getattr(self.lr_scheduler, "last_batch_iteration", 0) < 0:
            self.lr_scheduler.step()
        log_dist(f"DeepSpeed LR Scheduler = {self.lr_scheduler}", ranks=[0])

    def _configure_loss_scaler(self):
        """The scaler's device state: dynamic (the fp16 section's
        arguments, hysteresis 2 unless it names one), static (the
        configured scale, never updated), or 1.0 without fp16."""
        dev = self.device
        if self.dynamic_loss_scale():
            args = self.dynamic_loss_scale_args() or {}
            self.scaler_state = init_dynamic_scaler_state(
                init_scale=args.get("init_scale", self.initial_dynamic_scale()),
                delayed_shift=args.get("delayed_shift", 2), device=dev)
            self._scaler_kwargs = dict(scale_window=args.get("scale_window", 1000),
                                       min_scale=args.get("min_scale", 1.0),
                                       delayed_shift=args.get("delayed_shift", 2))
        else:
            scale = self._config.loss_scale if self.fp16_enabled() else 1.0
            self.scaler_state = init_dynamic_scaler_state(init_scale=scale, device=dev)
            self._scaler_kwargs = None

    def deepspeed_io(self, dataset, batch_size=None, route=ROUTE_TRAIN, pin_memory=None,
                     data_sampler=None, collate_fn=None, num_local_io_workers=None):
        """A ``DeepSpeedDataLoader`` over ``dataset``: this process's
        micro-batches of its share of the samples."""
        if batch_size is None:
            batch_size = self.train_micro_batch_size_per_gpu()
        return DeepSpeedDataLoader(
            dataset=dataset, batch_size=batch_size,
            collate_fn=collate_fn or self.collate_fn,
            num_replicas=self.dp_world_size, rank=self.mesh.rank(DATA_AXIS),
            data_sampler=data_sampler,
            tput_timer=self.tput_timer if route == ROUTE_TRAIN else None)

    def _configure_activation_checkpointing(self):
        """Configure ``checkpointing`` from the config's section. With the
        section enabled, flip the model config's per-layer switch in place
        (shared config objects are affected, as in the JAX engine) and,
        under ``cpu_checkpointing``, its ``checkpoint_policy`` to
        ``offload_dots``; a model with no such switch has its whole
        forward recomputed, under ``offload_dots`` with
        ``cpu_checkpointing``."""
        checkpointing.configure(self.mpu, deepspeed_config=self._config._param_dict)
        self._remat_module = False
        self._remat_fallback_policy = None
        ac_cfg = self._config.activation_checkpointing_config
        if not ac_cfg.enabled:
            return
        offload = bool(ac_cfg.cpu_checkpointing)
        mcfg = getattr(self.module, "config", None)
        if mcfg is not None and hasattr(mcfg, "checkpoint_activations"):
            if not mcfg.checkpoint_activations:
                mcfg.checkpoint_activations = True
                log_dist("activation checkpointing: setting "
                         f"{type(mcfg).__name__}.checkpoint_activations=True in place "
                         "(shared config objects are affected)", ranks=[0])
            if offload and not hasattr(mcfg, "checkpoint_policy"):
                logger.warning(
                    "cpu_checkpointing requested but "
                    f"{type(mcfg).__name__} exposes no settable checkpoint_policy — "
                    "activations stay on the device (per-layer recompute still active)")
            elif offload:
                mcfg.checkpoint_policy = "offload_dots"
                log_dist("cpu_checkpointing: checkpoint_policy='offload_dots' — saved "
                         "activations go to host memory (pinned)", ranks=[0])
        else:
            self._remat_module = True
            self._remat_fallback_policy = "offload_dots" if offload else "nothing"
            log_dist("activation checkpointing: recomputing the whole forward "
                     "(the model exposes no per-layer switch)"
                     + (" with host-offloaded saves" if offload else ""), ranks=[0])

    # ------------------------------------------------------------------
    # the step's pieces
    # ------------------------------------------------------------------
    def _next_seed(self):
        return int(torch.randint(0, 2**62, (1,), generator=self._step_gen))

    def _to_device(self, x):
        return torch.as_tensor(x).to(self.device, non_blocking=True)

    def _batch(self, mb):
        return tuple(self._to_device(x) for x in (mb if isinstance(mb, (tuple, list)) else (mb,)))

    def _loss(self, batch, deterministic=False):
        """The module's scalar fp32 loss on ``batch``; a training forward
        hands the module this microbatch's dropout seed."""
        if self._zero3:
            self.optimizer.gather_params()
        kwargs = {}
        if deterministic:
            if "deterministic" in inspect.signature(self.module.forward).parameters:
                kwargs["deterministic"] = True
        elif getattr(self.module, "needs_rng", False):
            kwargs["dropout_seed"] = self._next_seed()
        if not deterministic and self.progressive_layer_drop is not None:
            kwargs.update(progressive_layer_drop=True,
                          pld_theta=self.progressive_layer_drop.get_theta(),
                          pld_seed=int(torch.randint(0, 2**62, (1,),
                                                     generator=self._pld_gen)))
        if self._remat_module and torch.is_grad_enabled():
            out = checkpoint_call(self.module, *batch, policy=self._remat_fallback_policy,
                                  **kwargs)
        else:
            out = self.module(*batch, **kwargs)
        loss = out[0] if isinstance(out, tuple) else out
        return loss.float()

    def _accumulation_factor(self):
        gas = self.gradient_accumulation_steps()
        if self.postscale_gradients():
            return 1.0 / gas
        return 1.0 / (gas * self.gradient_predivide_factor())

    def _accumulate(self):
        """acc += grad * factor in fp32, then drop the module's grads (done
        in the backward's gradient hooks under ZeRO's ``overlap_comm``)."""
        if self._grads_in_hooks:
            return
        grads = [p.grad.float() if p.grad is not None else torch.zeros_like(a)
                 for p, a in zip(self._params, self._acc_grads)]
        torch._foreach_add_(self._acc_grads, grads, alpha=self._accumulation_factor())
        for p in self._params:
            p.grad = None

    def _scaled(self, loss):
        """The loss to backpropagate: times the loss scale under fp16."""
        return loss * self.scaler_state.cur_scale if self.fp16_enabled() else loss

    def allreduce_gradients(self):
        """The accumulated gradients reduced over the ranks, as the views
        the step optimizer updates from: at stage 0 their mean, all-reduced
        (a no-op at world 1); under ZeRO the part of the mean this rank
        steps (``ZeroShardedOptimizer.reduce_gradients``)."""
        return self._step_optimizer.reduce_gradients()

    def _update(self):
        """The one step sequence of every ZeRO stage: reduce the
        accumulated gradients over the ranks, then under fp16 check them
        for overflow (the one host read of the step; MAX over the ranks)
        and skip an overflowing step; otherwise unscale, take the norm (its
        squares summed over the ranks) and clip, and step the optimizer at
        the schedule's LR, which casts the masters into the module. Then
        advance the loss scaler and zero the accumulators. Returns the
        overflow verdict as a host bool."""
        opt = self._step_optimizer
        grads = self.allreduce_gradients()
        overflow = self.fp16_enabled() and bool(device_get(opt.has_overflow(grads),
                                                           _OVERFLOW_READ))
        if overflow:
            gnorm = torch.tensor(-1.0, device=self.device)
        else:
            if self.fp16_enabled():
                torch._foreach_div_(grads, self.scaler_state.cur_scale)
            clip = self.gradient_clipping()
            if self._onebit:
                gnorm = opt.step(grads, self.get_lr()[0], clip)
            else:
                gnorm = opt.global_norm(grads)
                if clip > 0:
                    clip_grad_norm_(grads, clip, global_grad_norm=gnorm)
                opt.update(grads, lr=self.get_lr()[0])
        self.scaler_state = advance_scaler(self.scaler_state, overflow,
                                           self.dynamic_loss_scale(), self._scaler_kwargs)
        opt.zero_grad()
        self.last_grad_norm = gnorm
        return overflow

    def _finish_step_bookkeeping(self, overflow):
        """Skip counting and the LR schedule, which steps only on a clean
        step."""
        self._last_overflow = overflow
        if overflow:
            self.skipped_steps += 1
            if self.dynamic_loss_scale():
                cur_scale = float(self.scaler_state.cur_scale)
                logger.info("[deepspeed_tpu_torch] OVERFLOW! Skipping step. Attempted loss "
                            f"scale: {cur_scale * 2}, reducing to {cur_scale}")
        elif self.lr_scheduler is not None:
            self.lr_scheduler.step()
        self.global_steps += 1
        self.global_samples += self.train_batch_size()
        if self.progressive_layer_drop is not None:
            self.progressive_layer_drop.update_state(self.global_steps)
        if self.global_steps % self.steps_per_print() == 0:
            log_dist(f"step={self.global_steps}, skipped={self.skipped_steps}, "
                     f"lr={self.get_lr()}, mom={self.get_mom()}", ranks=[0])

    def _monitor_step(self):
        """Record the step's scalars, keyed by ``global_samples``:
        ``Train/Samples/{train_loss,lr}``, ``loss_scale`` under fp16,
        ``Train/comm_overlap_frac`` where the optimizer has
        ``overlap_comm``, ``Train/offload_overlap_frac`` under
        ZeRO-Offload, and the microstep timers under
        ``wall_clock_breakdown``, and after the profiled step of the FLOPS
        profiler ``Train/Samples/model_tflops`` (and ``mfu`` where the
        card's peak is known). Values may be device tensors: the monitor
        reads them on the host only at its flush."""
        gauges, self._flops_gauges = self._flops_gauges, None
        if self.monitor is None:
            return
        samples = self.global_samples
        if gauges is not None:
            achieved, mfu = gauges
            self.monitor.record("Train/Samples/model_tflops", achieved, samples)
            if mfu is not None:
                self.monitor.record("Train/Samples/mfu", mfu, samples)
        if self._loss_sum is not None:
            self.monitor.record("Train/Samples/train_loss",
                                self._loss_sum / self.gradient_accumulation_steps(), samples)
        self.monitor.record("Train/Samples/lr", self.get_lr()[0], samples)
        if hasattr(self.optimizer, "overlap_comm"):
            # of the B per-bucket reduces the backward emits, all but the
            # last have backward compute left to hide under (0 without
            # overlap: the one reduce hides under nothing)
            frac = 0.0
            if self.optimizer.overlap_comm:
                b = len(self.optimizer.bucket_numels or ())
                frac = (b - 1) / b if b > 0 else 0.0
            self.monitor.record("Train/comm_overlap_frac", frac, samples)
        offload_stats = getattr(self.optimizer, "last_offload_stats", None)
        if offload_stats is not None:
            # measured: the share of the offload stages' summed time hidden
            # by their running side by side
            self.monitor.record("Train/offload_overlap_frac", offload_stats["overlap_frac"],
                                samples)
        if self.fp16_enabled():
            # a later step replaces the scaler's tensors and never writes them
            self.monitor.record("Train/Samples/loss_scale", self.scaler_state.cur_scale,
                                samples)
        if self.wall_clock_breakdown():
            # elapsed_ accumulates until timers.log() resets it every
            # steps_per_print: record the step's delta
            for name in ("forward_microstep", "backward_microstep"):
                t = self.timers.timers.get(name)
                if t is None or t.started_:
                    continue
                prev = self._timer_prev.get(name, 0.0)
                delta = t.elapsed_ - prev if t.elapsed_ >= prev else t.elapsed_
                self._timer_prev[name] = t.elapsed_
                self.monitor.record(f"Train/Samples/{name}", delta * 1000.0, samples)

    def _report_breakdown(self):
        """Every ``steps_per_print`` steps: flush the monitor, and log the
        microstep timers under ``wall_clock_breakdown`` (the card's memory
        beside them under ``memory_breakdown``, alone without the
        timers)."""
        if self.global_steps % self.steps_per_print() != 0:
            return
        if self.monitor is not None:
            self.monitor.flush()
        if self.wall_clock_breakdown():
            self.timers.log(["forward_microstep", "backward_microstep", "step_microstep"],
                            memory_breakdown=self.memory_breakdown())
        elif self.memory_breakdown():
            log_dist(f"step={self.global_steps} {self.timers.memory_usage()}", ranks=[0])

    def _start_timers(self, name):
        if self.wall_clock_breakdown():
            self.timers(f"{name}_microstep").start()
            self.timers(name).start(sync=False)

    def _stop_timers(self, name):
        if self.wall_clock_breakdown():
            self.timers(name).stop(sync=False)
            self.timers(f"{name}_microstep").stop()

    def close(self):
        """Flush and close the monitors (their files stay)."""
        if self.monitor is not None:
            self.monitor.close()

    def _optimizer_base_lr(self):
        return getattr(self.basic_optimizer, "lr", 1e-3)

    def get_lr(self):
        if self.lr_scheduler is not None:
            try:
                return self.lr_scheduler.get_last_lr()
            except AssertionError:
                # not stepped yet: peek without moving the schedule
                if hasattr(self.lr_scheduler, "get_lr"):
                    return self.lr_scheduler.get_lr()
        return [self._optimizer_base_lr()]

    def get_mom(self):
        if self.lr_scheduler is not None and hasattr(self.lr_scheduler, "get_mom"):
            return self.lr_scheduler.get_mom()
        return [getattr(self.basic_optimizer, "betas", (0.9,))[0]]

    # ------------------------------------------------------------------
    # three-call API
    # ------------------------------------------------------------------
    def forward(self, *inputs):
        """The loss of one microbatch. In training mode the loss carries
        the autograd graph for ``backward``; in eval mode it is computed
        without grad and deterministically. At the FLOPS profiler's
        ``profile_step`` the first microbatch's forward through backward
        is the profiled window."""
        self._start_timers("forward")
        batch = self._batch(inputs)
        if not self.training:
            with torch.no_grad():
                loss = self._loss(batch, deterministic=True)
        else:
            if self._profiles_now():
                self._sync()
                self.flops_profiler.start_profile()
                self._profile_batch = batch
            with (self._tracer.span("train/forward_backward", cat="train",
                                    args={"step": self.global_steps})
                  if self._tracer.enabled else _NULL_SPAN):
                loss = self._loss(batch)
            self._last_loss = loss.detach()
        self._stop_timers("forward")
        return loss

    __call__ = forward

    def backward(self, loss):
        """Backpropagate ``loss`` (times the loss scale under fp16) and
        accumulate the gradients (times the accumulation factor) into the
        fp32 buffers."""
        self._start_timers("backward")
        self._scaled(loss).backward()
        self._accumulate()
        # the monitor's train_loss is the boundary step's mean microbatch
        # loss (a device add, no wait for the card)
        if self.monitor is not None and self._last_loss is not None:
            self._loss_sum = (self._last_loss
                              if self.micro_steps % self.gradient_accumulation_steps() == 0
                              else self._loss_sum + self._last_loss)
        self.micro_steps += 1
        self._stop_timers("backward")
        if self._profile_batch is not None:
            self._finish_profile()
        return loss

    # ------------------------------------------------------------------
    # the FLOPS profiler
    # ------------------------------------------------------------------
    def _profiles_now(self):
        return (self.flops_profiler is not None
                and self.global_steps == self._config.flops_profiler_config.profile_step
                and self.micro_steps % self.gradient_accumulation_steps() == 0)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _finish_profile(self):
        """Close the profiled window (forward through backward, the card
        synchronised), then count the microbatch in a pass of its own: its
        forward and backward under the counting mode, with both random
        streams put back after it and its gradients dropped (the module's
        ``.grad`` is empty between microbatches, and ZeRO's gradient hooks
        are paused), so training runs on as if unprofiled. The numbers, the
        count pass's host time and the report are kept in ``last_profile``."""
        prof = self.flops_profiler
        self._sync()
        prof.stop_profile()
        batch, self._profile_batch = self._profile_batch, None
        t0 = time.perf_counter()
        streams = (self._step_gen.get_state(), self._pld_gen.get_state())
        hooked = self._grads_in_hooks
        if hooked:
            self.optimizer.hooks_paused = True
        try:
            prof.count_step(lambda: self._scaled(self._loss(batch)),
                            lambda loss: loss.backward(), params=self.module)
        finally:
            for p in self._params:
                p.grad = None
            if hooked:
                self.optimizer.hooks_paused = False
            self._step_gen.set_state(streams[0])
            self._pld_gen.set_state(streams[1])
        self._sync()
        count_s = time.perf_counter() - t0
        prof.set_params(self.module)
        cfg = self._config.flops_profiler_config
        report = prof.print_model_profile(profile_step=self.global_steps,
                                          module_depth=cfg.module_depth,
                                          top_modules=cfg.top_modules, detailed=cfg.detailed) \
            if self.global_rank == 0 else None
        achieved = prof.achieved_tflops()
        if achieved is not None:
            # recorded by the step's _monitor_step
            self._flops_gauges = (achieved, prof.mfu())
        self.last_profile = {"flops": prof.flops, "duration_s": prof.duration,
                             "model_tflops": achieved, "mfu": prof.mfu(),
                             "count_s": count_s, "report": report}
        prof.end_profile()

    def is_gradient_accumulation_boundary(self):
        return self.micro_steps % self.gradient_accumulation_steps() == 0

    def step(self):
        """Apply the accumulated gradients at an accumulation boundary."""
        self._start_timers("step")
        boundary = self.is_gradient_accumulation_boundary() and self.micro_steps > 0
        if boundary:
            with (self._tracer.span("train/optimizer_step", cat="train",
                                    args=self._optimizer_step_args())
                  if self._tracer.enabled else _NULL_SPAN):
                overflow = self._update()
            self._finish_step_bookkeeping(overflow)
            self._monitor_step()
            self.tput_timer.stop(self.global_steps % self.steps_per_print() == 0)
        self._stop_timers("step")
        if boundary:
            self._report_breakdown()

    def _optimizer_step_args(self):
        args = {"step": self.global_steps}
        if self.zero_optimization() and self.zero_cpu_offload():
            args["offload"] = True
        return args

    # ------------------------------------------------------------------
    # fused step
    # ------------------------------------------------------------------
    def _can_fuse_train_step(self):
        return self.flops_profiler is None

    def train_step(self, microbatches):
        """One optimizer step over ``gradient_accumulation_steps``
        microbatches (each a tuple of batch tensors). Returns the mean
        (unscaled) loss as a device scalar: nothing here waits for the
        card but, under fp16, the overflow check. Each distinct signature
        of the microbatches is one program of ``_train_step_programs``,
        budgeted under ``jax_sentinels``."""
        assert self._can_fuse_train_step(), (
            "fused train_step unavailable for this config (profiling uses "
            "forward/backward/step)")
        if self._train_step_sentinel is not None:
            return self._train_step_sentinel(microbatches)
        return self._train_step_programs(microbatches)

    def _fused_train_step(self, microbatches):
        gas = self.gradient_accumulation_steps()
        micro = [self._batch(mb) for mb in microbatches]
        assert len(micro) == gas, f"need {gas} microbatches, got {len(micro)}"
        self.tput_timer.start(sync=False)
        losses = []
        guard = transfer_free() if self._transfer_guard else contextlib.nullcontext()
        with (self._tracer.span("train/fwd_bwd_opt_step", cat="train",
                                args={"step": self.global_steps, "gas": gas})
              if self._tracer.enabled else _NULL_SPAN), guard:
            for batch in micro:
                self._start_timers("forward")
                loss = self._loss(batch)
                self._stop_timers("forward")
                self._start_timers("backward")
                self._scaled(loss).backward()
                self._accumulate()
                self._stop_timers("backward")
                losses.append(loss.detach())
            self.micro_steps += gas
            self._start_timers("step")
            overflow = self._update()
            self._stop_timers("step")
            if self._tracer.enabled:
                # one child span a reduce (or offload) bucket: schedule
                # markers with the bucket's id and size, as the JAX engine's
                for b, n in enumerate(getattr(self.optimizer, "bucket_numels", None) or ()):
                    with self._tracer.span("train/grad_reduce", cat="train",
                                           args={"step": self.global_steps, "bucket": b,
                                                 "numel": n}):
                        pass
        loss = torch.stack(losses).mean()
        self._last_loss = loss
        if self.monitor is not None:
            self._loss_sum = loss * gas
        self._finish_step_bookkeeping(overflow)
        report = self.global_steps % self.steps_per_print() == 0
        self.tput_timer.stop(report, sync=report)
        self._monitor_step()
        self._report_breakdown()
        return loss

    def train_batch(self, data_iter=None):
        """``train_step`` over the next ``gradient_accumulation_steps``
        batches of ``data_iter``; returns the mean loss as a host float.
        Without ``data_iter`` it reads a fresh iterator of the engine's own
        loader (``training_data=``), which starts at the loader's first
        batch on every call, as the JAX engine's does. With a
        ``resilience`` block the step runs supervised: watchdog-bounded
        fetch, the divergence guard after the step, rollback recovery."""
        if data_iter is None:
            assert self.training_dataloader is not None, \
                "train_batch() without data_iter needs initialize(training_data=...)"
            data_iter = iter(self.training_dataloader)
        # job-level hooks first, where the masters and optimizer state are
        # whole: heartbeat, preemption, gossip, cluster fault arms
        self._cluster.step_boundary()
        gas = self.gradient_accumulation_steps()
        if self.resilience is not None:
            loss = self.resilience.train_batch(data_iter, self._train_batch_now, gas)
        else:
            with (self._tracer.span("train/batch_fetch", cat="train",
                                    args={"step": self.global_steps, "gas": gas})
                  if self._tracer.enabled else _NULL_SPAN):
                micro = [next(data_iter) for _ in range(gas)]
            loss = self._train_batch_now(micro)
        if self._slo is not None:
            # under policy "fail" a firing rule raises SloViolationError
            self._slo.evaluate(self._slo_registry.as_dict(pulled=False))
        return loss

    def _train_batch_now(self, micro):
        """One optimizer step over already-fetched microbatches (the
        unsupervised core of ``train_batch``); returns the mean loss as a
        host float. The resilience supervisor retries and replays it, so it
        reads only its arguments and the engine's state. With an armed
        FLOPS profiler the step runs the three calls."""
        if self._can_fuse_train_step():
            loss = self.train_step(micro)
        else:
            losses = []
            for mb in micro:
                loss = self.forward(*(mb if isinstance(mb, (tuple, list)) else (mb,)))
                self.backward(loss)
                losses.append(loss.detach())
                self.step()
            loss = torch.stack(losses).mean()
        # the step's one deliberate wait for the card: the mean loss
        with (self._tracer.span("train/loss_sync", cat="train",
                                args={"step": self.global_steps})
              if self._tracer.enabled else _NULL_SPAN):
            return float(loss)

    def master_params(self):
        """Named fp32 master parameters (the optimizer's view; under ZeRO
        gathered whole from every rank's slice, or from the host)."""
        return dict(zip(self._param_names, self._step_optimizer.master_params()))


    # ------------------------------------------------------------------
    # checkpointing, through the fault-tolerant runtime/checkpoint/
    # subsystem: atomic writes, a manifest commit record per tag,
    # retry/backoff, rotation, and the fall-back to the previous committed
    # tag on load
    # ------------------------------------------------------------------
    @property
    def checkpoint_storage(self):
        if getattr(self, "_ckpt_storage", None) is None:
            self._ckpt_storage = CheckpointStorage.from_ds_config(self._config)
        return self._ckpt_storage

    def _get_ckpt_name(self, checkpoints_path, tag):
        return os.path.join(checkpoints_path, str(tag), "mp_rank_00_model_states.pt")

    def _get_zero_ckpt_name(self, checkpoints_path, tag, pp_rank):
        return os.path.join(checkpoints_path, str(tag),
                            f"zero_pp_rank_{pp_rank}_mp_rank_00optim_states.pt")

    def module_state_dict(self):
        """What the JAX engine's ``params`` hold: the fp32 masters under the
        parameter names (gathered whole under ZeRO, a collective every rank
        joins), then the module's other state (buffers, frozen
        parameters) as it is."""
        state = dict(self.master_params())
        for name, t in self.module.state_dict().items():
            state.setdefault(name, t)
        return state

    def load_module_state_dict(self, state_dict, strict=True):
        """Load fp32 values into the masters in place (under ZeRO, this
        rank's slice of the flat master, or the host master) and cast them
        into the module's compute-dtype parameters as the step does; the
        module's other state is copied as it is."""
        trainable = set(self._param_names)
        own = self.module.state_dict()
        missing = [k for k in self._param_names if k not in state_dict]
        unexpected = [k for k in state_dict if k not in trainable and k not in own]
        if strict and (missing or unexpected):
            raise RuntimeError(f"Error(s) in loading the module state: missing keys "
                               f"{missing}, unexpected keys {unexpected}")
        current = self.master_params() if missing else {}
        values = [state_dict[k].float() if k in state_dict else current[k]
                  for k in self._param_names]
        self._step_optimizer.load_master_params(values)
        with torch.no_grad():
            for name, t in own.items():
                if name not in trainable and name in state_dict:
                    t.copy_(state_dict[name])

    def optimizer_state_dict(self):
        """Stage 0's optimizer state with whole tensors (gathered over the
        model group under tensor parallelism; ZeRO's is in the shard
        files)."""
        return self._step_optimizer.whole_state()

    def _checkpoint_tag_validation(self, tag):
        """The tag must be the same on every rank (a rank-unique tag breaks
        restores at another world size): the sha1 of the tag, gathered
        over the group."""
        if not self._config.checkpoint_tag_validation_enabled or self.dp_world_size == 1:
            return
        device = self.device if torch.distributed.get_backend() == "nccl" else "cpu"
        digest = torch.tensor(list(hashlib.sha1(str(tag).encode()).digest()),
                              dtype=torch.uint8, device=device)
        gathered = comm.all_gather(digest[None], self.mesh.group(DATA_AXIS))
        valid = all(torch.equal(g, gathered[0]) for g in gathered)
        msg = (f"[rank={self.global_rank}] The checkpoint tag '{tag}' is not consistent "
               "across all ranks. Including rank-unique information in the tag can break "
               "restores at a different world size.")
        if self._config.checkpoint_tag_validation_fail:
            assert valid, msg
        elif not valid:
            logger.warning(msg)

    def save_checkpoint(self, save_dir, tag=None, client_state=None, save_latest=True):
        """Write the tag: rank 0 the module file (fp32 masters, stage 0's
        optimizer state, the LR schedule, the loss scaler, the step's
        random stream, the counters and ``client_state``), every rank its
        ZeRO shard; then rank 0 commits the manifest, points ``latest`` at
        the tag and rotates. Every tensor is copied to the host first."""
        if tag is None:
            tag = f"global_step{self.global_steps}"
        client_state = client_state or {}
        self._checkpoint_tag_validation(tag)
        ckspan = (self._tracer.span("train/checkpoint_save", cat="train",
                                    args={"tag": tag, "step": self.global_steps})
                  if self._tracer.enabled else _NULL_SPAN)
        ckspan.__enter__()

        storage = self.checkpoint_storage
        writer = storage.tag_writer(save_dir, tag, uncommit=self.global_rank == 0)
        # both gather whole tensors under tensor parallelism: every rank
        # joins, rank 0 writes
        module = self.module_state_dict()
        optimizer = None if self.zero_optimization() else self.optimizer_state_dict()
        if self.global_rank == 0:
            state = dict(
                module=module,
                optimizer=optimizer,
                lr_scheduler=(self.lr_scheduler.state_dict()
                              if self.lr_scheduler is not None else None),
                scaler=self.scaler_state._asdict(),
                # the step's random stream: a resumed run draws the same
                # dropout seeds as the uninterrupted one
                step_rng=self._step_gen.get_state(),
                pld_rng=self._pld_gen.get_state(),
                # the flat layout's order, for zero_to_fp32
                param_shapes={n: tuple(module[n].shape) for n in self._param_names},
                skipped_steps=self.skipped_steps,
                global_steps=self.global_steps,
                global_samples=self.global_samples,
                dp_world_size=self.dp_world_size,
                mp_world_size=self.mp_world_size,
                # the global batch the trajectory was trained with: elastic
                # resume must preserve it across a world-size change
                train_batch_size=self.train_batch_size(),
            )
            state.update(client_state)
            writer.write_file(os.path.basename(self._get_ckpt_name(save_dir, tag)),
                              _serialize(_host_tree(state)))
            log_dist(f"Saving model checkpoint: {self._get_ckpt_name(save_dir, tag)}",
                     ranks=[0])
        del module

        if self.zero_optimization():
            self._save_zero_checkpoint(save_dir, tag, writer)

        if self.global_rank == 0:
            # the manifest is the commit record, written last: a crash
            # before it leaves the tag uncommitted and the previous one whole
            writer.commit(extra=dict(global_steps=self.global_steps,
                                     dp_world_size=self.dp_world_size,
                                     mp_world_size=self.mp_world_size))
            if save_latest:
                storage.write_latest(save_dir, tag)
            storage.rotate(save_dir)
        self._ckpt_commit_barrier(tag)
        if self._tracer.enabled:
            self._tracer.instant("checkpoint/commit", cat="lifecycle",
                                 args={"tag": tag, "step": self.global_steps})
        ckspan.__exit__(None, None, None)
        if self.resilience is not None:
            # the committed tag is the new rollback target; the replay
            # buffer restarts from here
            self.resilience.note_checkpoint(save_dir, tag)
        if self.monitor is not None:
            self.monitor.flush()
        return True

    def _ckpt_commit_barrier(self, tag):
        """Deadline-bounded rendezvous at the checkpoint commit point: a
        peer that died mid-save would leave every survivor blocked in the
        next collective. With ``resilience.comm_timeout_s`` a named
        ``CommTimeoutError`` surfaces within the deadline instead (over the
        gloo control group, never NCCL: ``comm/comm.py``); 0 or unset waits
        without bound. A single process skips the barrier unless a deadline
        is set, as in the JAX engine."""
        rc = self._config.resilience_config
        timeout_s = rc.comm_timeout_s or 0.0
        if dist.get_world_size() > 1 or timeout_s > 0:
            comm.barrier(f"ckpt_commit:{tag}", timeout_s=timeout_s or None)

    def _save_zero_checkpoint(self, save_path, tag, writer):
        """Every rank writes its own shard; rank 0 then inventories the
        other ranks' files for the manifest (digests read back from
        disk)."""
        name = lambda r: os.path.basename(self._get_zero_ckpt_name(save_path, tag, r))
        if self._pytree_zero:
            # one file of whole tensors (gathered over both groups, a
            # collective of every rank), as JAX's layout-agnostic save
            shard = dict(pytree_zero=True, dp_world_size=self.dp_world_size,
                         mp_world_size=self.mp_world_size,
                         master=dict(self.master_params()),
                         optimizer=self.optimizer.whole_state())
            if self.global_rank == 0:
                writer.write_file(name(0), _serialize(_host_tree(shard)))
            del shard
            log_dist(f"Saved the pytree zero state under tag {tag}", ranks=[0])
            return
        shard = self.optimizer.shard_state_dict()
        writer.write_file(name(self.global_rank), _serialize(shard))
        del shard
        if self.dp_world_size > 1:
            torch.distributed.barrier()
            if self.global_rank == 0:
                for r in range(1, self.dp_world_size):
                    writer.record_external_file(name(r))
        log_dist(f"Saved {self.dp_world_size} zero checkpoint shards under tag {tag}",
                 ranks=[0])

    def load_checkpoint(self, load_dir, tag=None, load_module_strict=True,
                        load_optimizer_states=True, load_lr_scheduler_states=True):
        """Restore from the requested tag, or, when it is corrupt or
        partial, fall back (loudly) to the newest committed tag. Raises
        ``CheckpointCorruptionError`` only when every candidate is
        corrupt; returns (None, {}) when there is no checkpoint at all."""
        storage = self.checkpoint_storage
        candidates = storage.load_candidates(load_dir, tag)
        if not candidates:
            logger.warning(
                f"No checkpoint found under {load_dir} (no committed tags, "
                "no usable 'latest' pointer" + (f", tag '{tag}' absent)" if tag else ")"))
            return None, {}
        failures = []
        for cand_tag, manifest in candidates:
            try:
                checkpoint = self._read_checkpoint_blobs(
                    load_dir, cand_tag, manifest, read_zero=load_optimizer_states)
            except CheckpointCorruptionError as e:
                failures.append((cand_tag, str(e)))
                logger.error(f"CHECKPOINT CORRUPT: tag '{cand_tag}' under {load_dir} failed "
                             f"verification ({e}); falling back to the previous committed tag")
                continue
            return self._apply_checkpoint(
                load_dir, cand_tag, checkpoint, load_module_strict=load_module_strict,
                load_optimizer_states=load_optimizer_states,
                load_lr_scheduler_states=load_lr_scheduler_states)
        raise CheckpointCorruptionError(
            f"every checkpoint candidate under {load_dir} is corrupt: "
            + "; ".join(f"{t}: {m}" for t, m in failures))

    def _read_checkpoint_blobs(self, load_dir, tag, manifest, read_zero=False):
        """Read, verify and unpickle everything the tag needs before any
        engine state changes, so a torn shard never leaves the engine half
        restored. Raises ``CheckpointCorruptionError`` on any defect."""
        storage = self.checkpoint_storage
        if manifest is not None and storage.verify_on_load:
            storage.verify_tag(load_dir, tag, manifest, deep=False)
        entries = manifest["files"] if manifest is not None else {}

        def read(path):
            name = os.path.basename(path)
            return _deserialize(storage.read_bytes(path, entry=entries.get(name), name=name),
                                name)

        checkpoint = read(self._get_ckpt_name(load_dir, tag))
        if not isinstance(checkpoint, dict):
            raise CheckpointCorruptionError(
                f"checkpoint state for tag '{tag}' is a {type(checkpoint).__name__}, "
                "expected dict")
        zero_shards = []
        if read_zero:
            pp_rank = 0
            while True:
                zname = self._get_zero_ckpt_name(load_dir, tag, pp_rank)
                if os.path.basename(zname) not in entries and not os.path.exists(zname):
                    break
                zero_shards.append(read(zname))
                pp_rank += 1
        checkpoint["_zero_shards"] = zero_shards
        return checkpoint

    def _apply_checkpoint(self, load_dir, tag, checkpoint, load_module_strict,
                          load_optimizer_states, load_lr_scheduler_states):
        ckpt_name = self._get_ckpt_name(load_dir, tag)
        zero_shards = checkpoint.pop("_zero_shards")
        self.load_module_state_dict(checkpoint["module"], strict=load_module_strict)
        # set before _load_zero_shards so its log reports the saved dp
        self.loaded_checkpoint_dp_world_size = checkpoint.get("dp_world_size", None)
        # elastic resume: a changed dp world size re-splits the preserved
        # global batch, or raises ElasticityIncompatibleWorldSize
        self._maybe_elastic_resume(checkpoint)

        if load_optimizer_states:
            # whole tensors: a stage 0 or tensor-parallel tag's optimizer
            # state, or a pytree ZeRO tag's one shard file
            whole = checkpoint.get("optimizer")
            pytree = [z for z in zero_shards if z.get("pytree_zero")]
            if whole is None and pytree:
                whole = pytree[0]["optimizer"]
            if self.zero_optimization() and not self._pytree_zero:
                if pytree:
                    raise ValueError("a pytree ZeRO tag (tensor parallel) does not load "
                                     "into the flat ZeRO optimizer: load it at stage 0 or "
                                     "under tensor parallelism")
                self._load_zero_shards(load_dir, tag, zero_shards)
            elif whole is not None:
                self._step_optimizer.load_whole_state(whole)

        if load_lr_scheduler_states and self.lr_scheduler is not None \
                and checkpoint.get("lr_scheduler"):
            self.lr_scheduler.load_state_dict(checkpoint["lr_scheduler"])

        if checkpoint.get("scaler") is not None:
            self.scaler_state = DynamicScalerState(
                **{k: v.to(self.device) for k, v in checkpoint["scaler"].items()})

        self.global_steps = checkpoint.get("global_steps", 0)
        self.global_samples = checkpoint.get("global_samples",
                                             self.global_steps * self.train_batch_size())
        self.skipped_steps = checkpoint.get("skipped_steps", 0)
        if checkpoint.get("step_rng") is not None:
            self._step_gen.set_state(checkpoint["step_rng"])
        if checkpoint.get("pld_rng") is not None:
            self._pld_gen.set_state(checkpoint["pld_rng"])
        if self.progressive_layer_drop is not None:
            # theta is a function of the step count: the value the next
            # step of the uninterrupted run would have used
            if self.global_steps > 0:
                self.progressive_layer_drop.update_state(self.global_steps)
            else:
                self.progressive_layer_drop.current_theta = 1.0

        client_state = {k: v for k, v in checkpoint.items() if k not in DEEPSPEED_STATES}
        if self.resilience is not None:
            self.resilience.note_restore(load_dir, tag)
        log_dist(f"Loaded checkpoint {ckpt_name} at global step {self.global_steps}",
                 ranks=[0])
        return ckpt_name, client_state

    def _maybe_elastic_resume(self, checkpoint):
        """A job restarted at another dp world size than the tag's. With
        elasticity enabled, check the new size against the elastic batch
        algebra (``ElasticityIncompatibleWorldSize`` when it cannot take
        the elastic global batch) and re-split the preserved global batch
        into micro x accumulation x world for this run; the engine's data
        loader is rebuilt for the new micro-batch. Without elasticity the
        global batch changes: warn loudly and go on."""
        saved_dp = checkpoint.get("dp_world_size", None)
        if not saved_dp or saved_dp == self.dp_world_size:
            return
        if not self.elasticity_enabled():
            logger.warning(
                f"[elasticity] checkpoint was saved at dp world size {saved_dp} but this "
                f"run has {self.dp_world_size} and elasticity is not enabled: the global "
                "batch (and the loss trajectory) will change. Enable the `elasticity` "
                "config block to preserve it across world-size changes.")
            return
        plan = compute_elastic_resume(
            self._config._param_dict, __version__, prev_world_size=saved_dp,
            new_world_size=self.dp_world_size,
            saved_train_batch_size=checkpoint.get("train_batch_size"))
        cfg = self._config
        changed = (cfg.train_micro_batch_size_per_gpu != plan["micro_batch_size"]
                   or cfg.gradient_accumulation_steps != plan["gradient_accumulation_steps"])
        if self._tracer.enabled:
            self._tracer.instant(
                "resilience/elastic_resume", cat="lifecycle",
                args={"prev_dp": saved_dp, "new_dp": self.dp_world_size,
                      "micro_batch_size": plan["micro_batch_size"],
                      "gas": plan["gradient_accumulation_steps"]})
        if changed and self._grads_in_hooks and plan["gradient_accumulation_steps"] != 1:
            raise ValueError(
                "elastic resume sets gradient_accumulation_steps to "
                f"{plan['gradient_accumulation_steps']}, and overlap_comm's gradient hooks "
                "reduce at gradient_accumulation_steps 1 only: resume without overlap_comm")
        cfg.train_batch_size = plan["train_batch_size"]
        cfg.train_micro_batch_size_per_gpu = plan["micro_batch_size"]
        cfg.gradient_accumulation_steps = plan["gradient_accumulation_steps"]
        if changed and self.training_data is not None:
            self.tput_timer.batch_size = plan["micro_batch_size"]
            self.training_dataloader = self.deepspeed_io(self.training_data)

    def _load_zero_shards(self, load_dir, tag, shards):
        """Re-partition the saved dp shards (already read and verified) for
        the current dp degree."""
        saved_dp = self.loaded_checkpoint_dp_world_size or self.dp_world_size
        if not shards:
            logger.warning(f"No zero checkpoint shards found in {load_dir}/{tag}")
            return
        self.optimizer.load_shard_state_dicts(shards)
        log_dist(f"Loaded {len(shards)} zero shards (saved dp={saved_dp}, current "
                 f"dp={self.dp_world_size})", ranks=[0])
