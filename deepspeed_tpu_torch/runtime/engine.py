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
- the ``activation_checkpointing`` section flips the model config's
  ``checkpoint_activations`` (per-layer recompute) or, for a model
  without that switch, recomputes the whole forward;
- one explicit step ``torch.Generator`` seeded from the config ``seed``
  (default 42) hands every microbatch one integer dropout seed;
- ``initialize`` starts the ``torch.distributed`` group from the
  launcher's environment (``utils/distributed.py``); at ZeRO stage 0 with
  more than one rank the accumulated gradients are all-reduced to their
  mean before the update;
- ZeRO stages 1-3 and ZeRO-Offload through ``runtime/zero``
  (``ZeroShardedOptimizer``): the fp16 overflow verdict and the gradient
  norm are then reduced over the ranks (MAX, and a SUM of squares), and
  under ``cpu_offload`` Adam runs on the host (``DeepSpeedCPUAdam``).
"""

import inspect

import torch

from deepspeed_tpu_torch.models.gpt2 import resolve_device
from deepspeed_tpu_torch.ops.adam.cpu_adam import DeepSpeedCPUAdam
from deepspeed_tpu_torch.ops.adam.fused_adam import FusedAdam
from deepspeed_tpu_torch.ops.utils_op import flatten_dense_tensors, unflatten_dense_tensors
from deepspeed_tpu_torch.ops.lamb.fused_lamb import FusedLamb
from deepspeed_tpu_torch.ops.sgd import SGD
from deepspeed_tpu_torch.runtime.activation_checkpointing.checkpointing import (
    checkpoint_call,
)
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.runtime.constants import (
    ADAM_OPTIMIZER,
    ADAMW_OPTIMIZER,
    LAMB_OPTIMIZER,
    MAX_GRAD_NORM,
    SGD_OPTIMIZER,
)
from deepspeed_tpu_torch.runtime.dataloader import DeepSpeedDataLoader
from deepspeed_tpu_torch.runtime.fp16.loss_scaler import (
    advance_scaler,
    init_dynamic_scaler_state,
)
from deepspeed_tpu_torch.runtime.lr_schedules import get_lr_schedule
from deepspeed_tpu_torch.runtime.utils import clip_grad_norm_, global_norm, has_overflow
from deepspeed_tpu_torch.runtime.zero.sharded_optimizer import ZeroShardedOptimizer
from deepspeed_tpu_torch.utils import distributed as dist
from deepspeed_tpu_torch.utils.logging import log_dist, logger
from deepspeed_tpu_torch.utils.timer import ThroughputTimer

ROUTE_TRAIN = "train"
ZERO_SUPPORTED_OPTIMIZERS = [ADAM_OPTIMIZER, ADAMW_OPTIMIZER, LAMB_OPTIMIZER]


class ReplicatedOptimizer:
    """ZeRO stage 0's side of the engine's step, with the ZeRO optimizer's
    interface: every rank holds the whole fp32 master and optimizer state.
    The accumulated gradients become their mean over the ranks (one
    all-reduce of their flat concatenation, skipped at world 1), the inner
    optimizer steps the master a tensor at a time, and the master is cast
    into the module's compute-dtype parameters."""

    def __init__(self, inner, master, params, names, compute_dtype):
        self.inner = inner
        self.master = master
        self.params = params
        self.names = names
        self.cast = compute_dtype != torch.float32
        self.state = None
        self.world = dist.group_rank_and_size()[1]
        self.acc_grads = [torch.zeros_like(m) for m in master]

    def reduce_gradients(self):
        if self.world > 1:
            flat = flatten_dense_tensors(self.acc_grads)
            torch.distributed.all_reduce(flat)
            flat.div_(self.world)
            torch._foreach_copy_(self.acc_grads, unflatten_dense_tensors(
                flat, [tuple(g.shape) for g in self.acc_grads]))
        return self.acc_grads

    def has_overflow(self, grads):
        return has_overflow(grads)    # the reduced gradients are alike on every rank

    def global_norm(self, grads):
        return global_norm(grads)

    def update(self, grads, lr=None):
        with torch.no_grad():
            if self.state is None:
                self.state = self.inner.init(self.master)
            self.inner.update(grads, self.state, self.master, lr=lr, names=self.names)
            if self.cast:
                torch._foreach_copy_([p.data for p in self.params], self.master)

    def zero_grad(self):
        with torch.no_grad():
            torch._foreach_zero_(self.acc_grads)


class DeepSpeedEngine:
    """Wraps a module for mixed-precision, data-parallel training."""

    def __init__(self, args=None, model=None, optimizer=None, model_parameters=None,
                 training_data=None, lr_scheduler=None, mpu=None,
                 dist_init_required=None, collate_fn=None, config=None,
                 config_params=None, device="cuda"):
        if mpu is not None:
            raise NotImplementedError("initialize(mpu=...) is not ported yet")
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
        self._config = DeepSpeedConfig(config)
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
        named = [(n, p) for n, p in self.module.named_parameters() if p.requires_grad]
        if model_parameters is not None:
            chosen = {id(p) for p in model_parameters}
            named = [(n, p) for n, p in named if id(p) in chosen]
        self._param_names = [n for n, _ in named]
        self._params = [p for _, p in named]
        self._zero3 = self.zero_optimization() and self.zero_optimization_stage() >= 3
        if self.zero_optimization():
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
        self.last_grad_norm = None
        self._last_overflow = False
        self._config.print("DeepSpeedEngine configuration")

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

    def gradient_clipping(self):
        return self._config.gradient_clipping

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
        if not self.zero_optimization():
            self.optimizer = basic_optimizer
            self._step_optimizer = ReplicatedOptimizer(
                basic_optimizer, self._master, self._params, self._param_names,
                self.compute_dtype)
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
            num_replicas=dist.get_world_size(), rank=dist.get_rank(),
            data_sampler=data_sampler,
            tput_timer=self.tput_timer if route == ROUTE_TRAIN else None)

    def _configure_activation_checkpointing(self):
        """With the section enabled, flip the model config's per-layer
        switch in place (shared config objects are affected, as in the
        JAX engine), or recompute the whole forward when the model has no
        such switch."""
        self._remat_module = False
        if not self._config.activation_checkpointing_config.enabled:
            return
        mcfg = getattr(self.module, "config", None)
        if mcfg is not None and hasattr(mcfg, "checkpoint_activations"):
            if not mcfg.checkpoint_activations:
                mcfg.checkpoint_activations = True
                log_dist("activation checkpointing: setting "
                         f"{type(mcfg).__name__}.checkpoint_activations=True in place "
                         "(shared config objects are affected)", ranks=[0])
        else:
            self._remat_module = True
            log_dist("activation checkpointing: recomputing the whole forward "
                     "(the model exposes no per-layer switch)", ranks=[0])

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
        if self._remat_module and torch.is_grad_enabled():
            out = checkpoint_call(self.module, *batch, **kwargs)
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
        overflow = self.fp16_enabled() and bool(opt.has_overflow(grads))
        if overflow:
            gnorm = torch.tensor(-1.0, device=self.device)
        else:
            if self.fp16_enabled():
                torch._foreach_div_(grads, self.scaler_state.cur_scale)
            gnorm = opt.global_norm(grads)
            clip = self.gradient_clipping()
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
        if self.global_steps % self.steps_per_print() == 0:
            log_dist(f"step={self.global_steps}, skipped={self.skipped_steps}, "
                     f"lr={self.get_lr()}, mom={self.get_mom()}", ranks=[0])

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
        without grad and deterministically."""
        batch = self._batch(inputs)
        if not self.training:
            with torch.no_grad():
                return self._loss(batch, deterministic=True)
        return self._loss(batch)

    __call__ = forward

    def backward(self, loss):
        """Backpropagate ``loss`` (times the loss scale under fp16) and
        accumulate the gradients (times the accumulation factor) into the
        fp32 buffers."""
        self._scaled(loss).backward()
        self._accumulate()
        self.micro_steps += 1
        return loss

    def is_gradient_accumulation_boundary(self):
        return self.micro_steps % self.gradient_accumulation_steps() == 0

    def step(self):
        """Apply the accumulated gradients at an accumulation boundary."""
        if self.is_gradient_accumulation_boundary() and self.micro_steps > 0:
            self._finish_step_bookkeeping(self._update())
            self.tput_timer.stop(self.global_steps % self.steps_per_print() == 0)

    # ------------------------------------------------------------------
    # fused step
    # ------------------------------------------------------------------
    def train_step(self, microbatches):
        """One optimizer step over ``gradient_accumulation_steps``
        microbatches (each a tuple of batch tensors). Returns the mean
        (unscaled) loss as a device scalar: nothing here waits for the
        card but, under fp16, the overflow check."""
        gas = self.gradient_accumulation_steps()
        micro = [self._batch(mb) for mb in microbatches]
        assert len(micro) == gas, f"need {gas} microbatches, got {len(micro)}"
        self.tput_timer.start(sync=False)
        losses = []
        for batch in micro:
            loss = self._loss(batch)
            self._scaled(loss).backward()
            self._accumulate()
            losses.append(loss.detach())
        self.micro_steps += gas
        overflow = self._update()
        loss = torch.stack(losses).mean()
        self._finish_step_bookkeeping(overflow)
        report = self.global_steps % self.steps_per_print() == 0
        self.tput_timer.stop(report, sync=report)
        return loss

    def train_batch(self, data_iter=None):
        """``train_step`` over the next ``gradient_accumulation_steps``
        batches of ``data_iter``; returns the mean loss as a host float.
        Without ``data_iter`` it reads a fresh iterator of the engine's own
        loader (``training_data=``), which starts at the loader's first
        batch on every call, as the JAX engine's does."""
        if data_iter is None:
            assert self.training_dataloader is not None, \
                "train_batch() without data_iter needs initialize(training_data=...)"
            data_iter = iter(self.training_dataloader)
        micro = [next(data_iter) for _ in range(self.gradient_accumulation_steps())]
        return float(self.train_step(micro))

    def master_params(self):
        """Named fp32 master parameters (the optimizer's view; under ZeRO
        gathered whole from every rank's slice, or from the host)."""
        if self.zero_optimization():
            return dict(zip(self._param_names, self.optimizer.master_params()))
        return dict(zip(self._param_names, self._master))

