"""DeepSpeedEngine: training of a PyTorch module on one card.

Port of ``deepspeed_tpu/runtime/engine.py`` for the path
``initialize()`` -> ``train_step`` / ``train_batch`` (and the three-call
``forward`` / ``backward`` / ``step``), single process, ZeRO stage 0:

- mixed precision as the JAX engine does it: the engine holds fp32
  master parameters and fp32 Adam state, and the module's weights are
  the compute-dtype (bf16) copy that every forward runs on, so LayerNorm
  and softmax inputs are bf16 as in JAX (no ``torch.autocast``);
- gradient accumulation over ``gradient_accumulation_steps`` into fp32
  buffers, with the JAX engine's factor (1/gas, or 1/(gas * predivide)
  under ``prescale_gradients``);
- the shared update: global norm or clipping, then the optimizer on the
  masters, then the masters cast back into the module;
- the ``activation_checkpointing`` section flips the model config's
  ``checkpoint_activations`` (per-layer recompute) or, for a model
  without that switch, recomputes the whole forward;
- one explicit step ``torch.Generator`` seeded from the config ``seed``
  (default 42) hands every microbatch one integer dropout seed.
"""

import inspect

import torch

from deepspeed_tpu_torch.models.gpt2 import resolve_device
from deepspeed_tpu_torch.ops.adam.fused_adam import FusedAdam
from deepspeed_tpu_torch.runtime.activation_checkpointing.checkpointing import (
    checkpoint_call,
)
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.runtime.constants import (
    ADAM_OPTIMIZER,
    ADAMW_OPTIMIZER,
    MAX_GRAD_NORM,
)
from deepspeed_tpu_torch.runtime.utils import clip_grad_norm_, global_norm
from deepspeed_tpu_torch.utils.logging import log_dist
from deepspeed_tpu_torch.utils.timer import ThroughputTimer


class DeepSpeedEngine:
    """Wraps a module for mixed-precision training on one card."""

    def __init__(self, args=None, model=None, optimizer=None, model_parameters=None,
                 training_data=None, lr_scheduler=None, mpu=None,
                 dist_init_required=None, collate_fn=None, config=None,
                 config_params=None, device="cuda"):
        for name, value in (("training_data", training_data), ("lr_scheduler", lr_scheduler),
                            ("mpu", mpu), ("collate_fn", collate_fn)):
            if value is not None:
                raise NotImplementedError(f"initialize({name}=...) is not ported yet")
        if model is None:
            raise ValueError("deepspeed_tpu_torch.initialize requires a model")
        if not isinstance(model, torch.nn.Module):
            raise TypeError("model must be a torch.nn.Module")
        if config is None and args is not None:
            config = getattr(args, "deepspeed_config", None)
        if config is None:
            config = config_params
        assert config is not None, "DeepSpeed requires a config (config= or config_params=)"

        self.device = resolve_device(device)
        self._config = DeepSpeedConfig(config)
        self.global_steps = 0
        self.global_samples = 0
        self.micro_steps = 0
        self.skipped_steps = 0
        self.training = True
        self.lr_scheduler = None
        self.training_dataloader = None

        if self._config.bfloat16_enabled:
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
        if self.compute_dtype == torch.float32:
            for p in self._params:
                p.data = p.data.float()
            self._master = [p.data for p in self._params]   # updated in place
        else:
            self._master = [p.detach().float().clone() for p in self._params]
            self.module.to(self.compute_dtype)
        self._acc_grads = None

        self._configure_activation_checkpointing()

        self.tput_timer = ThroughputTimer(
            batch_size=self.train_micro_batch_size_per_gpu(), num_workers=1,
            steps_per_output=self.steps_per_print(),
            logging_fn=lambda msg: log_dist(msg, ranks=[0]))

        self.optimizer = optimizer if optimizer is not None else self._configure_basic_optimizer()
        self.basic_optimizer = self.optimizer
        self.opt_state = None
        self._step_gen = torch.Generator().manual_seed(int(self._config.seed))
        self.last_grad_norm = None
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

    def gradient_clipping(self):
        return self._config.gradient_clipping

    def postscale_gradients(self):
        return not self._config.prescale_gradients

    def gradient_predivide_factor(self):
        return self._config.gradient_predivide_factor

    def optimizer_name(self):
        return self._config.optimizer_name

    def optimizer_params(self):
        return self._config.optimizer_params

    def train(self, mode=True):
        self.training = mode

    def eval(self):
        self.training = False

    def _configure_basic_optimizer(self):
        name = self.optimizer_name()
        params = dict(self.optimizer_params() or {})
        params.pop(MAX_GRAD_NORM, None)
        if name is None:
            raise ValueError("'optimizer' was not specified in the config and no "
                             "optimizer instance was passed")
        name = name.lower()
        if name in (ADAM_OPTIMIZER, ADAMW_OPTIMIZER):
            return FusedAdam(adam_w_mode=(name == ADAMW_OPTIMIZER), **params)
        raise ValueError(f"Unknown optimizer name {name}")

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
        """acc += grad * factor in fp32, then drop the module's grads."""
        if self._acc_grads is None:
            self._acc_grads = [torch.zeros_like(m) for m in self._master]
        grads = [p.grad.float() if p.grad is not None else torch.zeros_like(m)
                 for p, m in zip(self._params, self._master)]
        torch._foreach_add_(self._acc_grads, grads, alpha=self._accumulation_factor())
        for p in self._params:
            p.grad = None

    def _ensure_opt_state(self):
        if self.opt_state is None:
            self.opt_state = self.optimizer.init(self._master)

    def _update(self):
        """Clip (or just measure) the accumulated gradients, step the
        optimizer on the fp32 masters, cast the masters into the module,
        and zero the accumulators."""
        self._ensure_opt_state()
        grads = self._acc_grads
        clip = self.gradient_clipping()
        if clip > 0:
            gnorm = clip_grad_norm_(grads, clip)
        else:
            gnorm = global_norm(grads)
        lr = getattr(self.basic_optimizer, "lr", 1e-3)
        with torch.no_grad():
            self.optimizer.update(grads, self.opt_state, self._master, lr=lr,
                                  names=self._param_names)
            if self.compute_dtype != torch.float32:
                torch._foreach_copy_([p.data for p in self._params], self._master)
            torch._foreach_zero_(self._acc_grads)
        self.last_grad_norm = gnorm

    def _finish_step_bookkeeping(self):
        self.global_steps += 1
        self.global_samples += self.train_batch_size()
        if self.global_steps % self.steps_per_print() == 0:
            log_dist(f"step={self.global_steps}, skipped={self.skipped_steps}, "
                     f"lr={self.get_lr()}", ranks=[0])

    def get_lr(self):
        return [getattr(self.basic_optimizer, "lr", 1e-3)]

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
        """Backpropagate ``loss`` and accumulate the gradients (times the
        accumulation factor) into the fp32 buffers."""
        loss.backward()
        self._accumulate()
        self.micro_steps += 1
        return loss

    def is_gradient_accumulation_boundary(self):
        return self.micro_steps % self.gradient_accumulation_steps() == 0

    def step(self):
        """Apply the accumulated gradients at an accumulation boundary."""
        if self.is_gradient_accumulation_boundary() and self.micro_steps > 0 \
                and self._acc_grads is not None:
            self._update()
            self._finish_step_bookkeeping()
            self.tput_timer.stop(self.global_steps % self.steps_per_print() == 0)

    # ------------------------------------------------------------------
    # fused step
    # ------------------------------------------------------------------
    def train_step(self, microbatches):
        """One optimizer step over ``gradient_accumulation_steps``
        microbatches (each a tuple of batch tensors). Returns the mean
        loss as a device scalar: nothing here waits for the card."""
        gas = self.gradient_accumulation_steps()
        micro = [self._batch(mb) for mb in microbatches]
        assert len(micro) == gas, f"need {gas} microbatches, got {len(micro)}"
        self.tput_timer.start(sync=False)
        losses = []
        for batch in micro:
            loss = self._loss(batch)
            loss.backward()
            self._accumulate()
            losses.append(loss.detach())
        self.micro_steps += gas
        self._update()
        loss = torch.stack(losses).mean()
        self._finish_step_bookkeeping()
        report = self.global_steps % self.steps_per_print() == 0
        self.tput_timer.stop(report, sync=report)
        return loss

    def train_batch(self, data_iter):
        """``train_step`` over the next ``gradient_accumulation_steps``
        batches of ``data_iter``; returns the mean loss as a host float."""
        micro = [next(data_iter) for _ in range(self.gradient_accumulation_steps())]
        return float(self.train_step(micro))

    def master_params(self):
        """Named fp32 master parameters (the optimizer's view)."""
        return dict(zip(self._param_names, self._master))

