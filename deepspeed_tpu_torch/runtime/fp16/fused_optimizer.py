"""FP16_Optimizer: mixed precision without ZeRO.

Port of ``deepspeed_tpu/runtime/fp16/fused_optimizer.py``: fp32 masters of
fp16 (or bf16) params, a scaled loss, then per step the overflow check ->
dynamic-scale backoff and step skip, or unscale -> global-norm clipping ->
the inner optimizer on the masters -> masters copied into the params.

The inner optimizer keeps the port's convention (``init(masters)``,
``update(grads, state, masters, lr=)`` over lists of tensors, in place).
Where the JAX class skips with ``lax.cond`` on the device, this one reads
the overflow flag on the host once a step and skips the update in Python;
the scaler itself advances on the device. The engine runs the same steps
inline (``runtime/engine.py``); this class packages them for direct use.
"""

import dataclasses
from typing import NamedTuple

import torch

from deepspeed_tpu_torch.runtime.fp16.loss_scaler import (
    DynamicScalerState,
    advance_scaler,
    init_dynamic_scaler_state,
)
from deepspeed_tpu_torch.runtime.utils import clip_grad_norm_, has_overflow


class FP16OptimizerState(NamedTuple):
    master: list                   # fp32 masters, one per param
    inner_state: object            # the inner optimizer's state over them
    scaler: DynamicScalerState


def _tree_zip(fn, x, y):
    """``fn(a, b)`` on every pair of tensors of two nests of the same
    structure (NamedTuples, dataclasses, lists, tuples, dicts); any other
    value is taken from ``y``."""
    if isinstance(x, torch.Tensor):
        return fn(x, y)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_tree_zip(fn, a, b) for a, b in zip(x, y)))
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return type(x)(**{f.name: _tree_zip(fn, getattr(x, f.name), getattr(y, f.name))
                          for f in dataclasses.fields(x)})
    if isinstance(x, (list, tuple)):
        assert len(x) == len(y), "FP16_Optimizer state mismatch on load"
        return type(x)(_tree_zip(fn, a, b) for a, b in zip(x, y))
    if isinstance(x, dict):
        return {k: _tree_zip(fn, x[k], y[k]) for k in x}
    return y


class FP16_Optimizer:
    """Wraps an inner optimizer (``FusedAdam``, ``FusedLamb``, ``SGD``)."""

    def __init__(self, init_optimizer, static_loss_scale=1.0, dynamic_loss_scale=False,
                 initial_dynamic_scale=2 ** 32, dynamic_loss_args=None, verbose=True,
                 clip_grad=0.0, fused_adam_legacy=False):
        self.inner = init_optimizer
        self.clip_grad = clip_grad
        self.dynamic = dynamic_loss_scale
        args = dynamic_loss_args or {}
        self._scaler_kwargs = dict(scale_window=args.get("scale_window", 1000),
                                   min_scale=args.get("min_scale", 1.0),
                                   delayed_shift=args.get("delayed_shift", 1))
        self._init_scale = (args.get("init_scale", initial_dynamic_scale)
                            if dynamic_loss_scale else static_loss_scale)
        self.lr = getattr(init_optimizer, "lr", 1e-3)
        self.overflow = False
        self.skipped_steps = 0

    def init(self, params):
        master = [p.detach().float().clone() for p in params]
        device = master[0].device if master else None
        return FP16OptimizerState(
            master=master, inner_state=self.inner.init(master),
            scaler=init_dynamic_scaler_state(
                init_scale=self._init_scale,
                delayed_shift=self._scaler_kwargs["delayed_shift"], device=device))

    def scale_loss(self, loss, state):
        """The loss times the current scale, to backpropagate."""
        return loss * state.scaler.cur_scale

    def step(self, grads, state, params, lr=None, names=None):
        """Overflow check -> unscale -> clip by global norm -> the inner
        step on the fp32 masters -> masters copied into ``params`` (in
        place, in their dtype). Returns (params, state, overflow), the
        overflow a host bool."""
        lr = self.lr if lr is None else lr
        overflow = bool(has_overflow(grads))   # the step's one host read
        self.overflow = overflow
        if overflow:
            self.skipped_steps += 1
        else:
            scale = state.scaler.cur_scale
            grads32 = [g.float() / scale for g in grads]
            if self.clip_grad > 0:
                clip_grad_norm_(grads32, self.clip_grad)
            with torch.no_grad():
                self.inner.update(grads32, state.inner_state, state.master, lr=lr,
                                  names=names)
        with torch.no_grad():
            torch._foreach_copy_(list(params), state.master)
        scaler = advance_scaler(state.scaler, overflow, self.dynamic, self._scaler_kwargs)
        return params, state._replace(scaler=scaler), overflow

    # -- checkpoints --------------------------------------------------------
    def state_dict(self, state):
        """A host copy of ``state``."""
        return _tree_zip(lambda t, _: t.detach().cpu().clone(), state, state)

    def load_state_dict(self, template_state, blob, load_optimizer_states=True):
        """``blob`` (a ``state_dict``) on ``template_state``'s devices and
        dtypes."""
        return _tree_zip(lambda t, b: torch.as_tensor(b).to(device=t.device, dtype=t.dtype),
                         template_state, blob)


class FP16_UnfusedOptimizer(FP16_Optimizer):
    """The reference's per-tensor variant (used for LAMB and generic
    optimizers). The port's optimizers already work tensor by tensor, so
    the fused / unfused distinction collapses; kept for API parity."""
