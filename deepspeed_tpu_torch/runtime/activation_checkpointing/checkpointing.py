"""Activation checkpointing (rematerialization).

Port of ``deepspeed_tpu/runtime/activation_checkpointing/checkpointing.py``:
recompute in backward with the same dropout bits, the Megatron-style RNG
tracker, ``checkpoint()`` / ``checkpoint_wrapper``, ``configure()`` with
its flags, and the named policies the model configs share:

- ``"nothing"``: save nothing, recompute the whole layer in backward (a
  plain non-reentrant ``torch.utils.checkpoint``);
- ``"dots"``: save the outputs of the non-batched matmuls (``aten.mm``
  and ``aten.addmm``, what ``dots_with_no_batch_dims_saveable`` saves in
  JAX) on the device and recompute the rest, through selective
  checkpointing;
- ``"offload_dots"`` (the ``cpu_checkpointing`` flag): the same outputs
  saved, but held in pinned host memory between forward and backward. In
  the forward each matmul output is copied device-to-host on a side
  stream (the forward goes on; the allocator keeps the output's memory
  until the copy ends), and in the recompute the matmul is not run: its
  output comes back host-to-device on the compute stream. The recompute
  reads the same bits ``dots`` keeps on the device, so the gradients are
  the same bit for bit.

Under every policy the attention kernel (not a matmul) is recomputed. The
port's layers draw their dropout from explicit generators seeded by an
integer argument, which the recompute passes again, so the global RNG
state is not stashed for them; ``checkpoint()`` (the public call, for
functions that may draw from the global generators) stashes it.

``partition_activations``, ``contiguous_memory_optimization`` and
``number_checkpoints`` are flags with JAX's checks: the JAX package maps
them onto its compiler, and the port keeps their state only.
"""

import collections
import functools
import json
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint as _torch_checkpoint,
    create_selective_checkpoint_contexts,
)

from deepspeed_tpu_torch.runtime.activation_checkpointing.config import (
    DeepSpeedActivationCheckpointingConfig,
)
from deepspeed_tpu_torch.runtime.utils import fold_seed
from deepspeed_tpu_torch.utils.logging import logger

# module state of configure(), as the JAX module's
_CONFIG = None
_MPU = None
_NUM_LAYERS = None
_PARTITION_ACTIVATIONS = False
_CPU_CHECKPOINT = False
_CONTIGUOUS_CHECKPOINTING = False
_SYNCHRONIZE = False
_PROFILE_TIME = False


# ---------------------------------------------------------------------------
# RNG tracker
# ---------------------------------------------------------------------------

_MODEL_PARALLEL_RNG_TRACKER_NAME = "model-parallel-rng"


class RNGStatesTracker:
    """Named dropout seeds. ``fork(name)`` hands out the integer seed
    ``fold_seed(seed, uses)`` (``runtime/utils.py``), where ``uses`` counts
    the earlier forks of ``name``: the n-th fork of a name added with the
    same seed is always the same seed, and two forks never are. This is
    JAX's ``fold_in(key, uses)`` for layers that take integer seeds. A
    checkpointed call receives its forked seed as an argument, so its
    recompute draws the masks it drew the first time."""

    def __init__(self):
        self.states_ = {}
        self.uses_ = {}

    def reset(self):
        self.states_.clear()
        self.uses_.clear()

    def get_states(self):
        return dict(self.states_), dict(self.uses_)

    def set_states(self, states):
        self.states_, self.uses_ = dict(states[0]), dict(states[1])

    def add(self, name, seed):
        if name in self.states_:
            raise Exception(f"seed {name} already exists")
        self.states_[name] = int(seed)
        self.uses_[name] = 0

    def fork(self, name=_MODEL_PARALLEL_RNG_TRACKER_NAME):
        if name not in self.states_:
            raise Exception(f"rng state {name} is not added")
        seed = fold_seed(self.states_[name], self.uses_[name])
        self.uses_[name] += 1
        return seed


_RNG_TRACKER = RNGStatesTracker()


def get_cuda_rng_tracker():
    """The process's seed tracker (the name is the reference's)."""
    return _RNG_TRACKER


def model_parallel_cuda_manual_seed(seed):
    """One seed for data-parallel-replicated ops (returned), and the
    tracker's model-parallel seed ``seed + 2718 + mp_rank`` for regions
    that differ across the model-parallel ranks."""
    mp_rank = _MPU.get_model_parallel_rank() if _MPU is not None else 0
    model_parallel_seed = seed + 2718 + mp_rank
    _RNG_TRACKER.reset()
    _RNG_TRACKER.add(_MODEL_PARALLEL_RNG_TRACKER_NAME, model_parallel_seed)
    return int(seed)


# ---------------------------------------------------------------------------
# policies
# ---------------------------------------------------------------------------

# Named policies shared by the model configs (BertConfig / GPT2Config
# checkpoint_policy)
REMAT_POLICIES = ("nothing", "dots", "offload_dots")
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)

# bytes the offload policy moved (and matmul outputs it saved / restored)
# since the last reset_offload_stats(): counted as each copy is enqueued
OFFLOAD_STATS = dict(d2h_bytes=0, h2d_bytes=0, saved=0, restored=0)
_COPY_STREAMS = {}


def reset_offload_stats():
    for k in OFFLOAD_STATS:
        OFFLOAD_STATS[k] = 0


def offload_stats():
    return dict(OFFLOAD_STATS)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _copy_stream(device):
    idx = torch.cuda.current_device() if device.index is None else device.index
    if idx not in _COPY_STREAMS:
        _COPY_STREAMS[idx] = torch.cuda.Stream(device=idx)
    return _COPY_STREAMS[idx]


def _to_host(t):
    """A host copy of the matmul output ``t``: on the card, pinned and
    enqueued on the side stream after the compute stream's work so far,
    with the event that marks its end; on the CPU a copy."""
    OFFLOAD_STATS["d2h_bytes"] += t.numel() * t.element_size()
    OFFLOAD_STATS["saved"] += 1
    if t.device.type != "cuda":
        return t.detach().clone(), None, t.device
    host = torch.empty_strided(t.size(), t.stride(), dtype=t.dtype, device="cpu",
                               pin_memory=True)
    stream = _copy_stream(t.device)
    stream.wait_stream(torch.cuda.current_stream(t.device))
    with torch.cuda.stream(stream):
        host.copy_(t, non_blocking=True)
        done = torch.cuda.Event()
        done.record(stream)
    t.record_stream(stream)
    return host, done, t.device


def _to_device(saved):
    host, done, device = saved
    OFFLOAD_STATS["h2d_bytes"] += host.numel() * host.element_size()
    OFFLOAD_STATS["restored"] += 1
    if device.type != "cuda":
        return host
    stream = torch.cuda.current_stream(device)
    stream.wait_event(done)
    out = torch.empty_strided(host.size(), host.stride(), dtype=host.dtype, device=device)
    out.copy_(host, non_blocking=True)
    return out


class _OffloadSaveMode(TorchDispatchMode):
    """The forward of an ``offload_dots`` region: every ``mm`` / ``addmm``
    output is copied to the host, in order."""

    def __init__(self, store):
        super().__init__()
        self.store = store

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in _SAVED_DOTS:
            self.store.append(_to_host(out))
        return out


class _OffloadLoadMode(TorchDispatchMode):
    """The recompute of an ``offload_dots`` region: an ``mm`` / ``addmm``
    returns its saved output, brought back to the device, in place of
    running; every other op runs again."""

    def __init__(self, store):
        super().__init__()
        self.store = store

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in _SAVED_DOTS:
            if not self.store:
                raise RuntimeError(
                    "offload_dots: a recompute ran more matmuls than its forward saved "
                    "(a second backward through the region?)")
            return _to_device(self.store.popleft())
        return func(*args, **(kwargs or {}))


def _offload_contexts():
    store = collections.deque()
    return _OffloadSaveMode(store), _OffloadLoadMode(store)


def resolve_remat_policy(name):
    """checkpoint_policy name -> the ``context_fn`` for
    ``torch.utils.checkpoint`` (None: save nothing)."""
    if name not in REMAT_POLICIES:
        raise ValueError(f"checkpoint_policy must be one of {REMAT_POLICIES}, got {name!r}")
    if name == "dots":
        return functools.partial(create_selective_checkpoint_contexts, _dots_policy)
    if name == "offload_dots":
        return _offload_contexts
    return None


def checkpoint_call(function, *args, policy="nothing", preserve_rng_state=False, **kwargs):
    """``function(*args, **kwargs)``, recomputed in backward under ``policy``."""
    context_fn = resolve_remat_policy(policy)
    extra = {} if context_fn is None else {"context_fn": context_fn}
    return _torch_checkpoint(function, *args, use_reentrant=False,
                             preserve_rng_state=preserve_rng_state, **extra, **kwargs)


# ---------------------------------------------------------------------------
# checkpoint()
# ---------------------------------------------------------------------------

def _remat_policy():
    """The policy of the configured flags: with ``cpu_checkpointing`` the
    engine's ``offload_dots``, else ``nothing``."""
    return "offload_dots" if _CPU_CHECKPOINT else "nothing"


def _synchronize(out):
    devices = {t.device for t in (out if isinstance(out, (tuple, list)) else (out,))
               if isinstance(t, torch.Tensor) and t.device.type == "cuda"}
    for d in devices:
        torch.cuda.synchronize(d)


def checkpoint(function, *args):
    """``function(*args)``, its intermediates recomputed in backward
    instead of saved (the global RNG state replayed for the recompute).
    With ``profile`` configured the forward's time is logged, after
    waiting for the card under ``synchronize_checkpoint_boundary``."""
    policy = _remat_policy()
    if _PROFILE_TIME:
        t0 = time.perf_counter()
        out = checkpoint_call(function, *args, policy=policy, preserve_rng_state=True)
        if _SYNCHRONIZE:
            _synchronize(out)
        logger.info(f"[checkpointing] forward took {time.perf_counter() - t0:.4f}s")
        return out
    return checkpoint_call(function, *args, policy=policy, preserve_rng_state=True)


def checkpoint_wrapper(fn):
    """Decorator form: ``fn`` recomputed in backward under the policy
    configured when it is wrapped."""
    policy = _remat_policy()

    @functools.wraps(fn)
    def wrapped(*args):
        return checkpoint_call(fn, *args, policy=policy, preserve_rng_state=True)

    return wrapped


def partition_activations_in_checkpoint(partition_activation):
    global _PARTITION_ACTIVATIONS
    _PARTITION_ACTIVATIONS = partition_activation
    logger.info(f"**************Partition Activations {partition_activation}************")


def set_num_layers(num_layers):
    global _NUM_LAYERS
    _NUM_LAYERS = num_layers


def configure(mpu_=None, deepspeed_config=None, partition_activations=None,
              contiguous_checkpointing=None, num_checkpoints=None,
              checkpoint_in_cpu=None, synchronize=None, profile=None):
    """Configure from a ds_config JSON path or dict, then from the
    explicit arguments, which win."""
    global _CONFIG, _MPU, _NUM_LAYERS, _PARTITION_ACTIVATIONS, _CPU_CHECKPOINT
    global _CONTIGUOUS_CHECKPOINTING, _SYNCHRONIZE, _PROFILE_TIME

    _MPU = mpu_
    if deepspeed_config is not None:
        if isinstance(deepspeed_config, dict):
            param_dict = deepspeed_config
        else:
            with open(deepspeed_config) as f:
                param_dict = json.load(f)
        _CONFIG = DeepSpeedActivationCheckpointingConfig(param_dict)
        _PARTITION_ACTIVATIONS = _CONFIG.partition_activations
        _CONTIGUOUS_CHECKPOINTING = _CONFIG.contiguous_memory_optimization
        _NUM_LAYERS = _CONFIG.number_checkpoints
        _CPU_CHECKPOINT = _CONFIG.cpu_checkpointing
        _SYNCHRONIZE = _CONFIG.synchronize_checkpoint_boundary
        _PROFILE_TIME = _CONFIG.profile

    if partition_activations is not None:
        _PARTITION_ACTIVATIONS = partition_activations
    if contiguous_checkpointing is not None:
        _CONTIGUOUS_CHECKPOINTING = contiguous_checkpointing
    if num_checkpoints is not None:
        _NUM_LAYERS = num_checkpoints
    if checkpoint_in_cpu is not None:
        _CPU_CHECKPOINT = checkpoint_in_cpu
    if synchronize is not None:
        _SYNCHRONIZE = synchronize
    if profile is not None:
        _PROFILE_TIME = profile

    if _CONTIGUOUS_CHECKPOINTING:
        assert _NUM_LAYERS is not None, "Must specify the number of checkpoints"
    if _CONTIGUOUS_CHECKPOINTING and not _PARTITION_ACTIVATIONS:
        raise Exception("Contiguous memory checkpointing is only available with "
                        "partitioned activation checkpointing")


def is_configured():
    """True after configure() ran."""
    return _CONFIG is not None or _PARTITION_ACTIVATIONS or _NUM_LAYERS is not None


def reset():
    """The reference frees its contiguous buffers here; the port holds
    none, and the flags stay as configured (as in the JAX package)."""
