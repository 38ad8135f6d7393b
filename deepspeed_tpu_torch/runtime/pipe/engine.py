"""PipelineEngine: pipeline-parallel (and data-parallel) training of a
``PipelineModule``.

Port of ``deepspeed_tpu/runtime/pipe/engine.py`` as the JAX engine's
single controller: one process interprets the instruction schedule of
every stage (``TrainSchedule`` 1F1B, or interleaved 1F1B with
``pipeline.num_model_chunks`` > 1, virtual stage p on physical stage
p % S). ``train_batch`` and ``eval_batch`` are the only entry points.

- Every stage lives on the process's device (``device=``, the card
  unless the caller asks for the CPU), so on one card the stages run one
  after the other: a step costs the sum of the stages' work, and the
  schedule's bubble is not visible there. ``stage_time_ms`` (device
  time between CUDA events at the start of each stage's turn, or host
  time on the CPU) feeds the estimate of a parallel step
  (``est_parallel_step_ms``: the busiest physical stage stretched by the
  simulated bubble).
- Send and receive hand a tensor to the next stage's queue, moved with
  ``.to(device, non_blocking=True)`` (a no-op on one device).
- A stage keeps only its input activations. ``BackwardPass`` re-runs
  the stage's forward with grad enabled and the same dropout seeds and
  takes ``torch.autograd.grad`` with respect to (the stage's parameters,
  its input). The last stage has no separate forward: its loss and
  gradients both come from its backward pass. A layer's dropout seed is
  folded from the config ``seed``, the global step, the micro-batch and
  the layer's index, so the recompute draws the forward's masks (the
  flash kernels draw from (seed, bh, qi, kj, row, col / 4)) and the
  masks do not depend on the partitioning.
- Gradients accumulate in fp32 per stage. At the ``OptimizerStep``
  barrier: the accumulators are averaged over the data-parallel group
  (``ReduceGrads``: an all-reduce, a no-op at world 1), tied gradients
  are summed into the owner (users zeroed), the global norm is taken
  over every stage, an fp16 overflow skips the step of every stage (one
  host read), and each stage's optimizer steps on ``acc * coeff /
  (micro_batches * scale)``; then the tied users copy the owner and the
  LR schedule steps (only on a step that was taken).
- bf16 or fp16 (static or dynamic loss scaling, the scale seeding the
  last stage's backward) with fp32 masters, or fp32. The optimizers are
  the port's FusedAdam / FusedLamb / SGD, one state per stage.
- Checkpoints: ``layer_XX-model_states.pt`` (each layer's fp32
  masters), ``optim_states.pt`` (the optimizer state split per layer)
  and ``module-meta.pt``, through ``runtime/checkpoint`` with the
  manifest as the commit point; the files are per layer, so a tag loads
  at another stage count.
- The ``resilience`` block runs ``train_batch`` under the supervisor;
  the step boundary runs the job-level hooks; the ``telemetry`` block
  arms the JAX engine's spans.
- The monitors (``tensorboard``, ``csv_monitor``, and the telemetry
  registry's bridge when the block arms it) get the JAX engine's
  ``Train/Samples/*`` and ``Train/Pipe/*`` records a step. They are host
  numbers once the step has read its losses, so the monitor is flushed
  every step: the registry's gauges are current after each step.
- ``activation_checkpointing.cpu_checkpointing`` is accepted and changes
  nothing: the JAX package applies it in its compiled executor only, and
  the interpreter (the port's one executor) stores each stage's
  activations either way.

- Tensor parallelism and ZeRO inside the stages (``tensor_parallel``,
  ``mesh``, ``initialize(mpu=...)``, ``zero_optimization.stage`` 1-3):
  one process a (data, model) rank, each driving every stage. Every
  layer is sharded after its weights are drawn (``shard_layers``); the
  accumulators are averaged over the data group only; with ZeRO each
  stage has a ``ZeroPytreeOptimizer`` over the data group (stage 3 runs
  as stage 2, as the JAX pipe's pytree optimizer does); the global norm
  and the fp16 overflow flag reduce over the model group as well; a tied
  layer's reduce carries the rank's shard. A tag holds whole tensors
  (gathered over both groups), so it loads at any data or model size
  and ``zero_to_fp32`` reads it.

Not ported here (refused by name): ``cpu_offload`` under a pipeline,
and the JAX ``"compiled"`` executor (one XLA program a step).
"""

import dataclasses
import os
import time
import weakref

import numpy as np
import torch

from deepspeed_tpu_torch import comm, telemetry
from deepspeed_tpu_torch.models.gpt2 import resolve_device
from deepspeed_tpu_torch.monitor import monitor_from_config
from deepspeed_tpu_torch.ops.adam.fused_adam import FusedAdam
from deepspeed_tpu_torch.ops.lamb.fused_lamb import FusedLamb
from deepspeed_tpu_torch.ops.sgd import SGD
from deepspeed_tpu_torch.ops.utils_op import flatten_dense_tensors, unflatten_dense_tensors
from deepspeed_tpu_torch.runtime.checkpoint import CheckpointCorruptionError, CheckpointStorage
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.runtime.config_utils import resolve_num_model_chunks, resolve_tp_size
from deepspeed_tpu_torch.runtime.constants import (
    ADAM_OPTIMIZER,
    ADAMW_OPTIMIZER,
    LAMB_OPTIMIZER,
    MAX_GRAD_NORM,
    PIPELINE_EXECUTOR,
    PIPELINE_EXECUTOR_DEFAULT,
    SGD_OPTIMIZER,
)
from deepspeed_tpu_torch.runtime.dataloader import DeepSpeedDataLoader, RepeatingLoader
from deepspeed_tpu_torch.parallel import tp
from deepspeed_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS
from deepspeed_tpu_torch.runtime.engine import (
    _deserialize,
    _host_tree,
    _serialize,
    configure_mesh,
)
from deepspeed_tpu_torch.runtime.zero.pytree_optimizer import ZeroPytreeOptimizer
from deepspeed_tpu_torch.runtime.fp16.loss_scaler import (
    DynamicScalerState,
    init_dynamic_scaler_state,
    update_scaler,
)
from deepspeed_tpu_torch.runtime.lr_schedules import get_lr_schedule
from deepspeed_tpu_torch.runtime.pipe import schedule as pipe_schedule
from deepspeed_tpu_torch.runtime.pipe.module import PipelineError, PipelineModule
from deepspeed_tpu_torch.runtime.resilience import ClusterHooks, ResilienceSupervisor
from deepspeed_tpu_torch.runtime.utils import fold_seed, global_norm, has_overflow
from deepspeed_tpu_torch.utils import distributed as dist
from deepspeed_tpu_torch.utils.logging import log_dist, logger
from deepspeed_tpu_torch.utils.timer import ThroughputTimer

_NULL_SPAN = telemetry.NULL_SPAN


def _map(fn, x):
    return tuple(fn(t) for t in x) if isinstance(x, tuple) else fn(x)


class PipelineEngine:
    """Interprets the pipeline instruction schedules of every stage."""

    def __init__(self, args=None, model=None, optimizer=None, model_parameters=None,
                 training_data=None, lr_scheduler=None, mpu=None, dist_init_required=None,
                 collate_fn=None, config=None, config_params=None, device="cuda"):
        if not isinstance(model, PipelineModule):
            raise TypeError("model must be a PipelineModule")
        if config is None and args is not None:
            config = getattr(args, "deepspeed_config", None)
        if config is None:
            config = config_params
        assert config is not None, "DeepSpeed requires a config (config= or config_params=)"
        if dist_init_required is None or dist_init_required:
            dist.init_distributed(verbose=False, device_type=torch.device(device).type)
        self.device = resolve_device(device)
        self.module = model
        self.collate_fn = collate_fn
        self.global_steps = 0
        self.global_samples = 0
        self.skipped_steps = 0
        self._last_overflow = False
        self.last_grad_norm = None

        # interleaved 1F1B: S * V virtual stages, virtual stage p on
        # physical stage p % S
        self.num_model_chunks = resolve_num_model_chunks(config)
        if self.num_model_chunks > 1:
            model.interleave_virtual_stages(self.num_model_chunks)
        self.num_stages = model.num_pipeline_stages()
        assert self.num_stages % self.num_model_chunks == 0, (
            f"module reports {self.num_stages} stages, not a multiple of "
            f"num_model_chunks {self.num_model_chunks}")
        self.num_phys_stages = self.num_stages // self.num_model_chunks

        # one process a (data, model) rank, each driving every stage: the
        # devices of a stage are the world's
        mp = resolve_tp_size(config, mpu)
        world = dist.get_world_size()
        assert world % mp == 0, (
            f"devices per stage {world} not divisible by tensor_parallel size {mp}")
        self.mesh = configure_mesh(config, mpu)
        self.mpu = mpu
        self.mp_world_size = self.mesh.shape[MODEL_AXIS]
        self.dp_world_size = self.mesh.shape[DATA_AXIS]
        self._dp_group = self.mesh.group(DATA_AXIS)
        self._mp_group = self.mesh.group(MODEL_AXIS)
        self._config = DeepSpeedConfig(config, world_size=self.dp_world_size)
        assert not self._config.elasticity_enabled, (
            "Elasticity is not currently supported with pipeline parallelism.")
        if self._config.zero_enabled and self._config.zero_config.cpu_offload:
            raise NotImplementedError(
                "zero_optimization.cpu_offload under a pipeline is not ported to "
                "deepspeed_tpu_torch (ROADMAP.md queue 1)")
        executor = str(self._config.pipeline.get(PIPELINE_EXECUTOR,
                                                  PIPELINE_EXECUTOR_DEFAULT)).lower()
        if executor == "compiled":
            raise NotImplementedError(
                "pipeline.executor 'compiled' (the JAX package's one-program step) is "
                "not ported: the port runs the interpreter (ROADMAP.md queue 1, Later: one "
                "CUDA graph a pipeline step); "
                "use 'auto' or 'interpreted'")
        if executor not in ("auto", "interpreted"):
            logger.warning(f"unknown pipeline.executor {executor!r} (valid: auto|compiled|"
                           "interpreted); using the interpreter")
        self.executor = "interpreted"
        self.global_rank = dist.get_rank()

        self.micro_batches = self._config.gradient_accumulation_steps
        self.micro_batch_size = self._config.train_micro_batch_size_per_gpu
        if self.num_model_chunks > 1 and self.micro_batches % self.num_phys_stages != 0:
            raise PipelineError(
                f"interleaved 1F1B (num_model_chunks={self.num_model_chunks}) "
                f"requires micro_batches ({self.micro_batches}) divisible by "
                f"pipeline stages ({self.num_phys_stages})")

        if self._config.fp16_enabled:
            self.compute_dtype = torch.float16
        elif self._config.bfloat16_enabled:
            self.compute_dtype = torch.bfloat16
        else:
            self.compute_dtype = torch.float32
        self._fp16 = self._config.fp16_enabled
        self._dynamic_scale = self._fp16 and self._config.loss_scale == 0
        self._configure_loss_scaler()
        self._seed = int(self._config.seed)

        self.tput_timer = ThroughputTimer(
            batch_size=self.micro_batch_size * self.micro_batches,
            num_workers=self.dp_world_size, steps_per_output=self._config.steps_per_print,
            logging_fn=lambda msg: log_dist(msg, ranks=[0]))

        self.client_optimizer = optimizer
        self.basic_optimizer = optimizer if optimizer is not None \
            else self._configure_basic_optimizer()
        self.optimizer = self.basic_optimizer
        self.training_dataloader = self._build_dataloader(training_data)
        self.lr_scheduler = None
        self._configure_lr_scheduler(lr_scheduler)

        self._place_params()
        self._tied = self._map_tied_layers()
        self.pipe_buffers = {}
        self.agg_train_loss = None

        telemetry.configure_from_config(self._config.telemetry_config,
                                        rank=self.global_rank, role="train")
        self._tracer = telemetry.get_tracer()
        # per-stage time of the last step (s), from the marks (a CUDA event,
        # or the host clock on the CPU) taken as each stage's turn starts
        self._stage_wall_s = [0.0] * self.num_stages
        self._marks = []

        # through a weak proxy, as the DeepSpeedEngine's: a reference cycle
        # would keep a dropped engine's device memory until a collection
        me = weakref.proxy(self)
        self.resilience = ResilienceSupervisor.from_ds_config(self._config, me)
        self._cluster = ClusterHooks(me)
        self.monitor = monitor_from_config(self._config, self.global_rank)

        ac_cfg = self._config.activation_checkpointing_config
        if ac_cfg.enabled and ac_cfg.cpu_checkpointing:
            log_dist("pipeline cpu_checkpointing: the JAX package applies 'offload_dots' in "
                     "its compiled executor only; the interpreter keeps each stage's "
                     "activations as it does without it", ranks=[0])

        # engine-only config sections must not silently no-op here
        if self._config.flops_profiler_config.enabled:
            logger.warning(
                "flops_profiler per-module attribution is not implemented "
                "for PipelineEngine (it works on DeepSpeedEngine's forward "
                "graph) — flops totals are skipped; per-stage wall-time "
                "gauges (Train/Pipe/stage*_time_ms) are exported through "
                "the monitor instead")
        if self._config.prescale_gradients or self._config.gradient_predivide_factor != 1.0:
            logger.warning("prescale_gradients/gradient_predivide_factor are applied by the "
                           "DeepSpeedEngine path; ignored under PipelineEngine")
        log_dist(f"PipelineEngine: stages={self.num_stages} dp={self.dp_world_size} "
                 f"micro_batches={self.micro_batches} device={self.device}\n"
                 f"{model.describe_partitions()}", ranks=[0])

    # ------------------------------------------------------------------
    # configuration
    # ------------------------------------------------------------------
    def _configure_basic_optimizer(self):
        name = (self._config.optimizer_name or ADAM_OPTIMIZER).lower()
        params = dict(self._config.optimizer_params or {})
        params.pop(MAX_GRAD_NORM, None)
        if name in (ADAM_OPTIMIZER, ADAMW_OPTIMIZER):
            return FusedAdam(adam_w_mode=(name == ADAMW_OPTIMIZER), **params)
        if name == LAMB_OPTIMIZER:
            return FusedLamb(**params)
        if name == SGD_OPTIMIZER:
            return SGD(**params)
        raise ValueError(f"Unknown optimizer {name} for pipeline engine")

    def _configure_lr_scheduler(self, client_lr_scheduler):
        if self._config.scheduler_name is not None:
            if client_lr_scheduler is not None:
                raise ValueError("Found both scheduler in config and lr_scheduler passed "
                                 "to initialize")
            self.lr_scheduler = get_lr_schedule(self._config.scheduler_name,
                                                self._config.scheduler_params)
        else:
            self.lr_scheduler = client_lr_scheduler
        if self.lr_scheduler is not None and \
                getattr(self.lr_scheduler, "last_batch_iteration", 0) < 0:
            self.lr_scheduler.step()

    def _configure_loss_scaler(self):
        if self._dynamic_scale:
            a = self._config.dynamic_loss_scale_args or {}
            self.scaler_state = init_dynamic_scaler_state(
                init_scale=a.get("init_scale", self._config.initial_dynamic_scale),
                delayed_shift=a.get("delayed_shift", 2), device=self.device)
            self._scaler_kwargs = dict(scale_window=a.get("scale_window", 1000),
                                       min_scale=a.get("min_scale", 1.0),
                                       delayed_shift=a.get("delayed_shift", 2))
        else:
            scale = self._config.loss_scale if self._fp16 else 1.0
            self.scaler_state = init_dynamic_scaler_state(init_scale=scale, device=self.device)
            self._scaler_kwargs = None

    def _build_dataloader(self, training_data):
        if training_data is None:
            return None
        return RepeatingLoader(DeepSpeedDataLoader(
            dataset=training_data, batch_size=self.micro_batch_size,
            collate_fn=self.collate_fn, num_replicas=self.dp_world_size,
            rank=self.mesh.rank(DATA_AXIS), tput_timer=self.tput_timer))

    def _stage_of_layer(self, idx):
        for s in range(self.num_stages):
            lo, hi = self.module.stage_layer_range(s)
            if lo <= idx < hi:
                return s
        raise ValueError(f"layer {idx} not in any stage")

    def _map_tied_layers(self):
        """tied key -> [(stage, layer index)], the first entry owns it."""
        return {key: [(self._stage_of_layer(i), i) for i in idxs]
                for key, idxs in self.module.tied_specs.items()}

    # ------------------------------------------------------------------
    # parameter placement: fp32 masters, compute-dtype layers
    # ------------------------------------------------------------------
    def _place_params(self):
        m = self.module
        m.init_params(lambda i: self.device)   # one device a process: every stage
        if self.mp_world_size > 1:
            m.shard_layers(self.mesh)
        cast = self.compute_dtype != torch.float32
        self._params, self._names, self._masters, self._acc = [], [], [], []
        # per stage, each parameter's model-axis placement (dim, sections) or
        # None, and whether it is an nn.Linear weight (the flax layout flips)
        self._tp, self._flips = [], []
        self._layer_slot = {}       # layer index -> (stage, start, end) in its stage's lists
        for s in range(self.num_stages):
            lo, hi = m.stage_layer_range(s)
            params, names, places, flips = [], [], [], []
            for idx in range(lo, hi):
                layer = m.get_layers()[idx]
                if not isinstance(layer, torch.nn.Module):
                    continue
                named = [(n, p) for n, p in layer.named_parameters() if p.requires_grad]
                if named:
                    self._layer_slot[idx] = (s, len(params), len(params) + len(named))
                params += [p for _, p in named]
                names += [f"layer_{idx:02d}.{n}" for n, _ in named]
                place = tp.sharded_params(layer)
                view = tp.flax_view(layer)
                places += [place.get(n) for n, _ in named]
                flips += [view[n][2] for n, _ in named]
            for p in params:
                p.data = p.data.float()
            masters = [p.detach().clone() for p in params] if cast else [p.data for p in params]
            if cast:
                for idx in range(lo, hi):
                    layer = m.get_layers()[idx]
                    if isinstance(layer, torch.nn.Module):
                        layer.to(self.compute_dtype)
            self._params.append(params)
            self._names.append(names)
            self._masters.append(masters)
            self._acc.append([torch.zeros_like(t) for t in masters])
            self._tp.append(places)
            self._flips.append(flips)
        self._opt_state = [None] * self.num_stages
        self._zero = None
        if self._config.zero_enabled:
            # one ZeRO-1/2 optimizer a stage over the data group; it holds
            # the stage's master parts and gradient accumulators
            self._zero = []
            for s in range(self.num_stages):
                if not self._params[s]:
                    self._zero.append(None)
                    continue
                z = ZeroPytreeOptimizer(self.basic_optimizer,
                                        stage=self._config.zero_optimization_stage,
                                        mesh=self.mesh)
                names = self._names[s]
                z.init(self._params[s], names, self._masters[s],
                       {n: t for n, t in zip(names, self._tp[s]) if t is not None},
                       dict(zip(names, self._flips[s])))
                self._masters[s] = z.master
                self._acc[s] = z.acc_grads
                self._zero.append(z)

    def _slot(self, lists, idx):
        s, a, b = self._layer_slot[idx]
        return lists[s][a:b]

    def _ensure_opt_state(self, s):
        if self._opt_state[s] is None:
            self._opt_state[s] = self.basic_optimizer.init(self._masters[s])
        return self._opt_state[s]

    # ------------------------------------------------------------------
    # public API: train_batch / eval_batch only
    # ------------------------------------------------------------------
    def forward(self, *args, **kwargs):
        raise PipelineError("Only train_batch() is accessible in pipeline mode.")

    def backward(self, *args, **kwargs):
        raise PipelineError("Only train_batch() is accessible in pipeline mode.")

    def step(self, *args, **kwargs):
        raise PipelineError("Only train_batch() is accessible in pipeline mode.")

    def _split_batch(self, batch):
        """batch -> (inputs, labels): the first stage takes the inputs, the
        last the labels."""
        if isinstance(batch, (tuple, list)) and len(batch) == 2:
            x, y = batch
        else:
            raise PipelineError("pipeline batches must be (inputs, labels) pairs")
        return _map(torch.as_tensor, x), _map(torch.as_tensor, y)

    def _to_stage(self, value, s):
        """``value`` moved to stage ``s``'s device (the process's card: a
        hand-off between stages is a no-op there)."""
        return _map(lambda t: t.to(self.device, non_blocking=True), value)

    def _inputs(self, x):
        """The first stage's inputs on the device, floating ones in the
        compute dtype (the stage's weights')."""
        return self._to_stage(_map(lambda t: t.to(self.compute_dtype)
                                   if t.is_floating_point() else t, x), 0)

    def train_batch(self, data_iter=None):
        """One optimizer step over ``gradient_accumulation_steps``
        micro-batches of ``data_iter`` ((inputs, labels) pairs); returns
        the mean loss as a host float."""
        if data_iter is None:
            assert self.training_dataloader is not None, "no training data"
            data_iter = iter(self.training_dataloader)
        self._cluster.step_boundary()
        if self.resilience is not None:
            return self.resilience.train_batch(data_iter, self._train_batch_now,
                                               self.micro_batches, transform=self._split_batch)
        micro = [self._split_batch(next(data_iter)) for _ in range(self.micro_batches)]
        return self._train_batch_now(micro)

    def _train_batch_now(self, micro):
        """One pipeline step over already-split micro-batches (the
        unsupervised core of ``train_batch``, which the resilience
        supervisor retries and replays)."""
        self.tput_timer.start(sync=False)
        self._run_schedule(micro)
        # the step's one deliberate wait for the card: every micro-batch's loss
        host_losses = torch.stack(self._losses).cpu().numpy()
        self._collect_stage_times()
        self.agg_train_loss = float(np.mean(host_losses))
        self.global_steps += 1
        self.global_samples += self.micro_batch_size * self.micro_batches * self.dp_world_size
        self._monitor_step()
        report = self.global_steps % self._config.steps_per_print == 0
        self.tput_timer.stop(report, sync=False)
        if report:
            log_dist(f"step={self.global_steps}, loss={self.agg_train_loss:.4f}, "
                     f"lr={self.get_lr()}", ranks=[0])
            if self._config.wall_clock_breakdown:
                # the interpreter runs the stages one after another, so the
                # step's wall time counts work a deployment overlaps: report
                # against the busiest rank's time stretched by the bubble
                est = self._est_parallel_step_s()
                if est > 0:
                    sps = self.micro_batch_size * self.micro_batches * self.dp_world_size / est
                    log_dist(f"wall_clock: train_batch {sps:.1f} samples/sec (bottleneck-"
                             f"stage estimate; schedule bubble "
                             f"{self._schedule_bubble_fraction():.3f})", ranks=[0])
        return self.agg_train_loss

    def _run_schedule(self, micro):
        self._losses = []
        if self.num_model_chunks > 1:
            sched = _MergedInterleavedSchedule(self.micro_batches, self.num_phys_stages,
                                               self.num_model_chunks)
        else:
            sched = _MergedSchedule(pipe_schedule.TrainSchedule, self.micro_batches,
                                    self.num_stages)
        with (self._tracer.span("pipe/exec_schedule", cat="pipe",
                                args={"step": self.global_steps,
                                      "micro_batches": self.micro_batches})
              if self._tracer.enabled else _NULL_SPAN):
            self._exec_schedule(sched, micro)

    def eval_batch(self, data_iter):
        """Mean loss over ``micro_batches`` batches in eval mode (dropout
        off: every layer that takes ``deterministic`` gets True)."""
        micro = [self._split_batch(next(data_iter)) for _ in range(self.micro_batches)]
        losses = []
        with torch.no_grad():
            for x, label in micro:
                act = self._inputs(x)
                for s in range(self.num_stages):
                    out = self.module.stage_forward(s, act, deterministic=True)
                    if s == self.num_stages - 1:
                        losses.append(self.module.loss_fn(
                            out, self._to_stage(label, s)).float())
                    else:
                        act = self._to_stage(out, s + 1)
        return float(np.mean(torch.stack(losses).cpu().numpy()))

    # ------------------------------------------------------------------
    # schedule execution
    # ------------------------------------------------------------------
    def _exec_schedule(self, sched, micro):
        S = self.num_stages
        self.pipe_buffers = {s: {} for s in range(S)}
        self._micro = micro
        # (stage, mark) as each tick starts; the next mark ends the tick
        self._marks = marks = []
        self._load_count = [0] * S
        self._fwd_count = [0] * S
        self._bwd_count = [0] * S
        self._step_pending = set()
        self._act_queue = {s: [] for s in range(S)}    # activations in flight to s
        self._grad_queue = {s: [] for s in range(S)}   # output grads in flight to s
        # dependency-driven interpretation: visit the stages round-robin
        # (the last first, so grads drain promptly), running a stage's next
        # tick only when its receives can be satisfied
        ticks = sched.per_stage
        pos = [0] * S
        total = sum(len(t) for t in ticks)
        done = 0
        while done < total:
            progressed = False
            for s in reversed(range(S)):
                if pos[s] >= len(ticks[s]):
                    continue
                tick = ticks[s][pos[s]]
                if not self._tick_ready(s, tick):
                    continue
                marks.append((s, self._mark()))
                for cmd in tick:
                    self._dispatch(s, cmd)
                pos[s] += 1
                done += 1
                progressed = True
            if not progressed:
                raise PipelineError(f"pipeline schedule deadlock at positions {pos}")
        marks.append((None, self._mark()))
        self.pipe_buffers = {}
        self._micro = None

    def _tick_ready(self, s, tick):
        need_act = sum(1 for c in tick if isinstance(c, pipe_schedule.RecvActivation))
        need_grad = sum(1 for c in tick if isinstance(c, pipe_schedule.RecvGrad))
        return len(self._act_queue[s]) >= need_act and len(self._grad_queue[s]) >= need_grad

    def _dispatch(self, s, cmd):
        name = _snake(type(cmd).__name__)
        fn = getattr(self, f"_exec_{name}", None)
        if fn is None:
            raise RuntimeError(f"{type(self).__name__} does not understand instruction {cmd}")
        with (self._tracer.span(f"pipe/{name}", cat="pipe", args={"stage": s})
              if self._tracer.enabled else _NULL_SPAN):
            fn(s, cmd)

    def _mark(self):
        if self.device.type != "cuda":
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    def _collect_stage_times(self):
        """Each stage's time in the last step: the intervals between
        consecutive marks (the step's loss read has waited for the last)."""
        wall = [0.0] * self.num_stages
        marks = self._marks
        if marks and not isinstance(marks[-1][1], float):
            marks[-1][1].synchronize()
        for (s, start), (_, end) in zip(marks, marks[1:]):
            wall[s] += end - start if isinstance(start, float) else \
                start.elapsed_time(end) / 1000.0
        self._stage_wall_s = wall
        self._marks = []

    # -- instructions ----------------------------------------------------
    def _mb_seed(self, mb_id):
        """The dropout seed of micro-batch ``mb_id`` of this step; the
        module folds in each layer's index, so a stage's recompute draws
        the forward's masks."""
        return fold_seed(self._seed, self.global_steps, mb_id)

    def _exec_load_micro_batch(self, s, cmd):
        mb_id = self._load_count[s]
        self._load_count[s] += 1
        x, label = self._micro[mb_id]
        buf = self.pipe_buffers[s]
        if s == 0:
            buf.setdefault("inputs", {})[cmd.buffer_id] = self._inputs(x)
        if s == self.num_stages - 1:
            buf.setdefault("labels", {})[cmd.buffer_id] = self._to_stage(label, s)

    def _exec_recv_activation(self, s, cmd):
        act = self._act_queue[s].pop(0)
        self.pipe_buffers[s].setdefault("inputs", {})[cmd.buffer_id] = self._to_stage(act, s)

    def _exec_forward_pass(self, s, cmd):
        mb_id = self._fwd_count[s]
        self._fwd_count[s] += 1
        if s == self.num_stages - 1:
            # the loss and the grads both come from the backward pass, which
            # 1F1B runs right after: a forward here would be pure recompute
            return
        x = self.pipe_buffers[s]["inputs"][cmd.buffer_id]
        with torch.no_grad():
            out = self.module.stage_forward(s, x, dropout_seed=self._mb_seed(mb_id))
        self.pipe_buffers[s].setdefault("outputs", {})[cmd.buffer_id] = out

    def _exec_send_activation(self, s, cmd):
        self._act_queue[s + 1].append(self.pipe_buffers[s]["outputs"].pop(cmd.buffer_id))

    def _exec_recv_grad(self, s, cmd):
        g = self._grad_queue[s].pop(0)
        self.pipe_buffers[s].setdefault("grad_out", {})[cmd.buffer_id] = self._to_stage(g, s)

    def _exec_backward_pass(self, s, cmd):
        buf = self.pipe_buffers[s]
        x = buf["inputs"][cmd.buffer_id]
        mb_id = self._bwd_count[s]
        self._bwd_count[s] += 1
        last = s == self.num_stages - 1
        params = self._params[s]
        with torch.enable_grad():
            xin = _map(lambda t: t.detach().requires_grad_(t.is_floating_point()), x)
            xin_all = xin if isinstance(xin, tuple) else (xin,)
            xs = [t for t in xin_all if t.requires_grad]
            out = self.module.stage_forward(s, xin, dropout_seed=self._mb_seed(mb_id))
            if last:
                loss = self.module.loss_fn(out, buf["labels"][cmd.buffer_id]).float()
                self._losses.append(loss.detach())
                # the loss scale seeds the backward (fp16); 1 otherwise
                pairs = [(loss, self.scaler_state.cur_scale.to(loss.device))]
            else:
                gout = buf["grad_out"].pop(cmd.buffer_id)
                outs = out if isinstance(out, tuple) else (out,)
                gouts = gout if isinstance(gout, tuple) else (gout,)
                pairs = [(o, g) for o, g in zip(outs, gouts) if g is not None]
            inputs = params + xs
            grads = torch.autograd.grad([o for o, _ in pairs], inputs,
                                        grad_outputs=[g for _, g in pairs],
                                        allow_unused=True) if inputs else ()
        acc = self._acc[s]
        got = [(a, g) for a, g in zip(acc, grads[:len(params)]) if g is not None]
        if got:
            torch._foreach_add_([a for a, _ in got], [g.float() for _, g in got])
        if s > 0:
            dxs = iter(grads[len(params):])
            dx = tuple(next(dxs) if t.requires_grad else None for t in xin_all)
            buf.setdefault("grad_in", {})[cmd.buffer_id] = dx if isinstance(x, tuple) else dx[0]

    def _exec_send_grad(self, s, cmd):
        self._grad_queue[s - 1].append(self.pipe_buffers[s]["grad_in"].pop(cmd.buffer_id))

    def _exec_reduce_tied_grads(self, s, cmd):
        """Done at the ``OptimizerStep`` barrier: every user's grads must be
        summed into the owner before any stage steps."""

    def _exec_reduce_grads(self, s, cmd):
        """Done at the ``OptimizerStep`` barrier (``_reduce_dp_grads``)."""

    def _reduce_dp_grads(self):
        """Average every stage's accumulators over the data-parallel group
        (one all-reduce of their flat concatenation; a no-op at data size
        1). With ZeRO each stage's optimizer reduces its own parts."""
        if self.dp_world_size <= 1 or self._zero is not None:
            return
        acc = [t for stage in self._acc for t in stage]
        flat = comm.all_reduce(flatten_dense_tensors(acc), self._dp_group)
        flat.div_(self.dp_world_size)
        torch._foreach_copy_(acc, unflatten_dense_tensors(flat, [tuple(t.shape) for t in acc]))

    def _reduce_tied_grads(self):
        """Sum the tied layers' grads into the owner's accumulators and zero
        the users'."""
        for entries in self._tied.values():
            owner = self._slot(self._acc, entries[0][1])
            for _, idx in entries[1:]:
                user = self._slot(self._acc, idx)
                torch._foreach_add_(owner, [u.to(o.device) for o, u in zip(owner, user)])
                torch._foreach_zero_(user)

    def _sync_tied_params(self):
        for entries in self._tied.values():
            owner_idx = entries[0][1]
            for _, idx in entries[1:]:
                torch._foreach_copy_(self._slot(self._masters, idx),
                                     self._slot(self._masters, owner_idx))
                if self.compute_dtype != torch.float32 or self._zero is not None:
                    torch._foreach_copy_([p.data for p in self._slot(self._params, idx)],
                                         [p.data for p in self._slot(self._params, owner_idx)])

    def _exec_optimizer_step(self, s, cmd):
        """Barrier: every stage's backwards must be done before the
        reductions, the global norm and overflow check, and the updates."""
        self._step_pending.add(s)
        if len(self._step_pending) < self.num_stages:
            return
        self._step_pending.clear()
        with torch.no_grad():
            self._reduce_dp_grads()
            self._reduce_tied_grads()
            self._update()

    def _grads_overflow(self, grads):
        """The fp16 overflow verdict over every stage and rank (one host read)."""
        if self._zero is not None:
            flags = [z.has_overflow(g) for z, g in zip(self._zero, grads) if z is not None]
            return bool(torch.stack(flags).any()) if flags else False
        flag = has_overflow([t for stage in grads for t in stage])
        if self.mp_world_size > 1:
            flag = comm.all_reduce(flag.float(), self._mp_group, comm.ReduceOp.MAX) > 0
        return bool(flag)

    def _grads_norm(self, grads):
        """The global L2 norm of the stages' reduced gradients, each element
        counted once: model-axis shards summed over the model group, ZeRO
        parts over the data group."""
        if self._zero is not None:
            sq = [z.global_norm(g) ** 2 for z, g in zip(self._zero, grads) if z is not None]
            return torch.sqrt(torch.stack(sq).sum())
        if self.mp_world_size == 1:
            return global_norm([t for stage in grads for t in stage])
        parts = torch.zeros(2, device=self.device)
        for s, stage in enumerate(grads):
            for i, g in enumerate(stage):
                parts[int(self._tp[s][i] is not None)] += g.float().pow(2).sum()
        return torch.sqrt(parts[0] + comm.all_reduce(parts[1:], self._mp_group)[0])

    def _update(self):
        # under ZeRO each stage reduces its parts here, after the tied sums
        grads = self._acc if self._zero is None else \
            [[] if z is None else z.reduce_gradients() for z in self._zero]
        scale = self.scaler_state.cur_scale
        mb = float(self.micro_batches)
        overflow = self._fp16 and self._grads_overflow(grads)
        if overflow:
            self.skipped_steps += 1
            for acc in self._acc:
                torch._foreach_zero_(acc)
            self.last_grad_norm = torch.tensor(-1.0, device=self.device)
            log_dist(f"[deepspeed_tpu_torch] OVERFLOW! Skipping pipeline step "
                     f"{self.global_steps}", ranks=[0])
        else:
            # the global norm over every stage (per-stage clipping would
            # change the update's direction against one stage); one factor
            # folds the averaging, the unscaling and the clip
            gnorm = self._grads_norm(grads) / (mb * scale)
            clip = self._config.gradient_clipping
            coeff = torch.ones_like(gnorm)
            if clip > 0:
                coeff = torch.where(gnorm > clip, clip / (gnorm + 1e-6), coeff)
            factor = coeff / (mb * scale)
            self.last_grad_norm = gnorm
            lr = self.get_lr()[0]
            for st in range(self.num_stages):
                if not self._masters[st]:
                    continue
                step_grads = torch._foreach_mul(grads[st], factor)
                if self._zero is not None:
                    # steps the master parts, all-gathers them into the layers
                    self._zero[st].update(step_grads, lr=lr)
                else:
                    self.basic_optimizer.update(step_grads, self._ensure_opt_state(st),
                                                self._masters[st], lr=lr,
                                                names=self._names[st])
                    if self.compute_dtype != torch.float32:
                        torch._foreach_copy_([p.data for p in self._params[st]],
                                             self._masters[st])
                torch._foreach_zero_(self._acc[st])
            self._sync_tied_params()
            if self.lr_scheduler is not None:
                self.lr_scheduler.step()
        self._last_overflow = overflow
        if self._dynamic_scale:
            self.scaler_state = update_scaler(self.scaler_state, overflow, **self._scaler_kwargs)

    # ------------------------------------------------------------------
    # per-stage times and the parallel-step estimate
    # ------------------------------------------------------------------
    def stage_time_ms(self):
        """Each (virtual) stage's time in the last step, ms."""
        return [t * 1000.0 for t in self._stage_wall_s]

    def _rank_wall_s(self):
        """Per physical stage: the sum of its virtual stages' times."""
        S = self.num_phys_stages
        out = [0.0] * S
        for p, wall_s in enumerate(self._stage_wall_s):
            out[p % S] += wall_s
        return out

    def _schedule_bubble_fraction(self):
        """The simulated idle fraction of the schedule's shape (S, M, V)
        on an S-way parallel machine."""
        key = (self.num_phys_stages, self.micro_batches, self.num_model_chunks)
        cached = getattr(self, "_bubble_cache", None)
        if cached is None or cached[0] != key:
            frac = pipe_schedule.simulate_bubble_fraction(
                stages=self.num_phys_stages, micro_batches=self.micro_batches,
                num_model_chunks=self.num_model_chunks)
            self._bubble_cache = (key, frac)
        return self._bubble_cache[1]

    def _est_parallel_step_s(self):
        """The step a deployment with one device a physical stage would
        take: the busiest stage's time stretched by the bubble."""
        ranks = self._rank_wall_s()
        busiest = max(ranks) if ranks else 0.0
        bubble = self._schedule_bubble_fraction()
        return busiest if bubble >= 1.0 else busiest / (1.0 - bubble)

    def _monitor_step(self):
        """The JAX engine's records of a step, keyed by ``global_samples``:
        ``Train/Samples/{train_loss,lr}`` (and ``loss_scale`` under fp16),
        each stage's time of this step, each physical rank's under
        interleaving, the schedule's bubble and the estimated parallel
        step; then a flush."""
        if self.monitor is None:
            return
        samples = self.global_samples
        record = self.monitor.record
        record("Train/Samples/train_loss", self.agg_train_loss, samples)
        record("Train/Samples/lr", self.get_lr()[0], samples)
        if self._fp16:
            record("Train/Samples/loss_scale", self.scaler_state.cur_scale, samples)
        for s, ms in enumerate(self.stage_time_ms()):
            record(f"Train/Pipe/stage{s}_time_ms", ms, samples)
        if self.num_model_chunks > 1:
            for r, wall_s in enumerate(self._rank_wall_s()):
                record(f"Train/Pipe/rank{r}_time_ms", wall_s * 1000.0, samples)
        record("Train/Pipe/bubble_frac", self._schedule_bubble_fraction(), samples)
        record("Train/Pipe/est_parallel_step_ms", self._est_parallel_step_s() * 1000.0,
               samples)
        self.monitor.flush()

    def close(self):
        """Flush and close the monitors (their files stay)."""
        if self.monitor is not None:
            self.monitor.close()

    # ------------------------------------------------------------------
    # engine-API parity
    # ------------------------------------------------------------------
    def get_lr(self):
        if self.lr_scheduler is not None:
            try:
                return self.lr_scheduler.get_last_lr()
            except AssertionError:
                return self.lr_scheduler.get_lr()
        return [getattr(self.basic_optimizer, "lr", 1e-3)]

    def loss_scale(self):
        return float(self.scaler_state.cur_scale) if self._fp16 else 1.0

    def train_micro_batch_size_per_gpu(self):
        return self.micro_batch_size

    def gradient_accumulation_steps(self):
        return self.micro_batches

    def train_batch_size(self):
        return self._config.train_batch_size

    def is_first_stage(self):
        return True    # single controller: this process drives every stage

    def is_last_stage(self):
        return True

    def master_params(self):
        """Named whole fp32 masters of every stage (tied users included;
        gathered over the data and model groups, a collective of every
        rank when the mesh has more than one)."""
        return {n: m for s in range(self.num_stages)
                for n, m in zip(self._names[s], self._whole_masters(s))}

    # -- whole tensors: a rank's parts gathered, and cut back ------------
    def _whole_tp(self, t, s, i):
        place = self._tp[s][i]
        return t if place is None else tp.whole_of(t, place[0], self._mp_group, place[1])

    def _tp_part(self, t, s, i):
        place = self._tp[s][i]
        if place is None:
            return t
        return tp.local_part(t, place[0], self.mesh.rank(MODEL_AXIS), self.mp_world_size,
                             place[1])

    def _whole_masters(self, s):
        if self._zero is not None:
            return [] if self._zero[s] is None else self._zero[s].master_params()
        return [self._whole_tp(m, s, i) for i, m in enumerate(self._masters[s])]

    def _load_whole_masters(self, s, values):
        if self._zero is not None:
            if self._zero[s] is not None:
                self._zero[s].load_master_params(values)
            return
        torch._foreach_copy_(self._masters[s], [
            self._tp_part(v.to(self.device, torch.float32), s, i)
            for i, v in enumerate(values)])
        if self.compute_dtype != torch.float32:
            torch._foreach_copy_([p.data for p in self._params[s]], self._masters[s])

    def _whole_opt_state(self, s):
        """Stage ``s``'s optimizer state with whole tensors: {field: one
        tensor a parameter, or a scalar}."""
        if self._zero is not None:
            return {} if self._zero[s] is None else self._zero[s].whole_state()
        state = self._ensure_opt_state(s)
        out = {}
        for f in dataclasses.fields(state):
            val = getattr(state, f.name)
            if isinstance(val, list):
                val = [self._whole_tp(t, s, i) for i, t in enumerate(val)]
            out[f.name] = val
        return out

    def _load_whole_opt_state(self, s, saved):
        if self._zero is not None:
            if self._zero[s] is not None:
                self._zero[s].load_whole_state(saved)
            return
        state = self._ensure_opt_state(s)
        for f in dataclasses.fields(state):
            cur = getattr(state, f.name)
            if isinstance(cur, list):
                torch._foreach_copy_(cur, [self._tp_part(v.to(c.device), s, i)
                                           for i, (c, v) in enumerate(zip(cur, saved[f.name]))])
            else:
                setattr(state, f.name, type(cur)(saved[f.name]))

    # ------------------------------------------------------------------
    # checkpointing: per-layer files
    # ------------------------------------------------------------------
    @property
    def checkpoint_storage(self):
        if getattr(self, "_ckpt_storage", None) is None:
            self._ckpt_storage = CheckpointStorage.from_ds_config(self._config)
        return self._ckpt_storage

    def _gather_layer_params(self):
        """Per layer (by global index): its whole fp32 masters by parameter
        name, or None for a layer without parameters (a collective of every
        rank when the mesh has more than one)."""
        out = [None] * self.module._num_layers
        whole = [self._whole_masters(s) for s in range(self.num_stages)]
        for idx, (s, a, b) in self._layer_slot.items():
            prefix = f"layer_{idx:02d}."
            out[idx] = {n[len(prefix):]: m for n, m in
                        zip(self._names[s][a:b], whole[s][a:b])}
        return out

    def _split_opt_state_per_layer(self):
        """Each stage's whole optimizer state split per layer: the list
        fields (one tensor a parameter) by layer, the rest (the step)
        once."""
        opt_global, opt_layers = {}, [dict() for _ in range(self.module._num_layers)]
        for s in range(self.num_stages):
            for name, val in self._whole_opt_state(s).items():
                if isinstance(val, list):
                    for idx, (st, a, b) in self._layer_slot.items():
                        if st == s:
                            opt_layers[idx][name] = val[a:b]
                else:
                    opt_global[name] = val
        return opt_global, opt_layers

    def save_checkpoint(self, save_dir, tag=None, client_state=None, save_latest=True):
        """Every rank gathers the whole fp32 masters and optimizer state;
        rank 0 writes them per layer with the meta file, then commits the
        manifest; every rank meets at the commit barrier."""
        if tag is None:
            tag = f"global_step{self.global_steps}"
        with (self._tracer.span("train/checkpoint_save", cat="train",
                                args={"tag": tag, "step": self.global_steps})
              if self._tracer.enabled else _NULL_SPAN):
            layers = self._gather_layer_params()
            opt = self._split_opt_state_per_layer()
            if self.global_rank == 0:
                self._write_tag(save_dir, tag, client_state or {}, save_latest, layers, opt)
            self._ckpt_commit_barrier(tag)
        if self.resilience is not None:
            self.resilience.note_checkpoint(save_dir, tag)
        return True

    def _write_tag(self, save_dir, tag, client_state, save_latest, layers, opt):
        storage = self.checkpoint_storage
        writer = storage.tag_writer(save_dir, tag)
        for idx, p in enumerate(layers):
            if p is not None:
                writer.write_file(f"layer_{idx:02d}-model_states.pt", _serialize(_host_tree(p)))
        opt_global, opt_layers = opt
        writer.write_file("optim_states.pt", _serialize(_host_tree(
            {"global": opt_global, "layers": opt_layers})))
        meta = dict(
            num_layers=self.module._num_layers, num_stages=self.num_stages,
            global_steps=self.global_steps, global_samples=self.global_samples,
            lr_scheduler=(self.lr_scheduler.state_dict()
                          if self.lr_scheduler is not None else None),
            scaler_state=self.scaler_state._asdict(), skipped_steps=self.skipped_steps,
            client_state=client_state)
        writer.write_file("module-meta.pt", _serialize(_host_tree(meta)))
        # the manifest is the commit point, written last
        writer.commit(extra=dict(global_steps=self.global_steps, num_stages=self.num_stages))
        if save_latest:
            storage.write_latest(save_dir, tag)
        storage.rotate(save_dir)

    def _ckpt_commit_barrier(self, tag):
        """Deadline-bounded rendezvous at the commit point (as the
        DeepSpeedEngine's); one process without a deadline skips it."""
        timeout_s = self._config.resilience_config.comm_timeout_s or 0.0
        if dist.get_world_size() > 1 or timeout_s > 0:
            comm.barrier(f"ckpt_commit:{tag}", timeout_s=timeout_s or None)

    def load_checkpoint(self, load_dir, tag=None, **kwargs):
        """Restore the requested tag (or, when it is corrupt, the newest
        committed one, loudly) onto the current stages; returns (path,
        client_state), or (None, {}) without a checkpoint."""
        storage = self.checkpoint_storage
        candidates = storage.load_candidates(load_dir, tag)
        if not candidates:
            logger.warning(f"no checkpoint found under {load_dir} (tag={tag}); starting fresh")
            return None, {}
        failures = []
        for cand_tag, manifest in candidates:
            try:
                blobs = self._read_pipe_checkpoint(load_dir, cand_tag, manifest)
            except CheckpointCorruptionError as e:
                logger.error(f"CHECKPOINT CORRUPT: tag '{cand_tag}' failed verification "
                             f"({e}); falling back to the previous committed tag")
                failures.append(f"{cand_tag}: {e}")
                continue
            return self._apply_pipe_checkpoint(load_dir, cand_tag, *blobs)
        raise CheckpointCorruptionError(
            f"no loadable checkpoint under {load_dir}; every candidate failed "
            f"verification: {'; '.join(failures)}")

    def _read_pipe_checkpoint(self, load_dir, tag, manifest):
        """Read, verify and unpickle every file of the tag before any
        engine state changes."""
        storage = self.checkpoint_storage
        if manifest is not None and storage.verify_on_load:
            storage.verify_tag(load_dir, tag, manifest, deep=False)
        path = os.path.join(load_dir, str(tag))
        entries = (manifest or {}).get("files", {})

        def present(name):
            return name in entries if manifest is not None else \
                os.path.exists(os.path.join(path, name))

        def read(name):
            return _deserialize(storage.read_bytes(os.path.join(path, name),
                                                   entry=entries.get(name), name=name), name)

        meta = read("module-meta.pt")
        if not isinstance(meta, dict) or "num_layers" not in meta:
            raise CheckpointCorruptionError(f"module-meta.pt of tag '{tag}' is malformed")
        layers = [read(n) if present(n) else None
                  for n in (f"layer_{i:02d}-model_states.pt" for i in range(meta["num_layers"]))]
        opt = read("optim_states.pt") if present("optim_states.pt") else None
        return meta, layers, opt

    def _apply_pipe_checkpoint(self, load_dir, tag, meta, layers, opt):
        if meta["num_layers"] != self.module._num_layers:
            raise ValueError(f"checkpoint has {meta['num_layers']} layers, the module "
                             f"{self.module._num_layers}")
        with torch.no_grad():
            # files are per layer of whole tensors: any stage count re-slices
            # them, and each rank cuts its data and model parts
            for s in range(self.num_stages):
                idxs = sorted((a, idx) for idx, (st, a, _) in self._layer_slot.items()
                              if st == s)
                values = []
                for _, idx in idxs:
                    prefix = f"layer_{idx:02d}."
                    _, a, b = self._layer_slot[idx]
                    values += [layers[idx][n[len(prefix):]] for n in self._names[s][a:b]]
                if values:
                    self._load_whole_masters(s, values)
            self._opt_state = [None] * self.num_stages
            for z in self._zero or ():
                if z is not None:
                    z.state = None
            if opt is not None and opt.get("global"):
                for s in range(self.num_stages):
                    idxs = [idx for _, idx in sorted(
                        (a, idx) for idx, (st, a, _) in self._layer_slot.items() if st == s)]
                    if not idxs:
                        continue
                    saved = dict(opt["global"])
                    for name in opt["layers"][idxs[0]]:
                        saved[name] = [t for idx in idxs for t in opt["layers"][idx][name]]
                    self._load_whole_opt_state(s, saved)
            for acc in self._acc:
                torch._foreach_zero_(acc)
        self.global_steps = meta["global_steps"]
        self.global_samples = meta["global_samples"]
        if meta.get("scaler_state") is not None:
            self.scaler_state = DynamicScalerState(
                **{k: v.to(self.device) for k, v in meta["scaler_state"].items()})
        self.skipped_steps = meta.get("skipped_steps", self.skipped_steps)
        if self.lr_scheduler is not None and meta.get("lr_scheduler"):
            self.lr_scheduler.load_state_dict(meta["lr_scheduler"])
        if self.resilience is not None:
            self.resilience.note_restore(load_dir, tag)
        return os.path.join(load_dir, str(tag)), meta.get("client_state", {})


class _MergedSchedule:
    """Every stage's instruction stream, for the dependency-driven
    interpreter."""

    def __init__(self, sched_cls, micro_batches, stages):
        self.per_stage = [
            list(sched_cls(micro_batches=micro_batches, stages=stages, stage_id=s).steps())
            for s in range(stages)]
        self.stages = stages


class _MergedInterleavedSchedule:
    """Each physical stage's ``InterleavedTrainSchedule`` stream, re-homed
    onto virtual stages ``chunk * S + rank``: a rank's tick is split into
    per-chunk ticks routed by each instruction's ``chunk_id``."""

    def __init__(self, micro_batches, phys_stages, num_model_chunks):
        S, V = phys_stages, num_model_chunks
        self.stages = S * V
        self.per_stage = [[] for _ in range(self.stages)]
        for r in range(S):
            sched = pipe_schedule.InterleavedTrainSchedule(
                micro_batches=micro_batches, stages=S, stage_id=r, num_model_chunks=V)
            for tick in sched.steps():
                by_chunk = {}
                for cmd in tick:
                    by_chunk.setdefault(cmd.chunk_id, []).append(cmd)
                for v, cmds in by_chunk.items():
                    self.per_stage[v * S + r].append(cmds)


def _snake(name):
    out = []
    for i, ch in enumerate(name):
        if ch.isupper() and i > 0:
            out.append("_")
        out.append(ch.lower())
    return "".join(out)
