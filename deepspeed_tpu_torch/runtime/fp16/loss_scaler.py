"""Static and dynamic loss scaling.

Port of ``deepspeed_tpu/runtime/fp16/loss_scaler.py`` (``LossScaler``,
``DynamicLossScaler``: x2 growth / halving backoff, ``scale_window``,
hysteresis via ``delayed_shift``, ``min_scale``) in two forms:

- a functional core (``DynamicScalerState`` + ``update_scaler``) whose
  state is four 0-d device tensors updated with ``torch.where``, so the
  engine's step advances it without reading anything on the host;
- class wrappers (``LossScaler``, ``DynamicLossScaler``) with the
  reference's host-side API for user code.
"""

from typing import NamedTuple

import torch

INITIAL_LOSS_SCALE = "init_scale"
SCALE_WINDOW = "scale_window"
DELAYED_SHIFT = "delayed_shift"
MIN_LOSS_SCALE = "min_scale"


class DynamicScalerState(NamedTuple):
    """Device-side scaler state: 0-d tensors."""

    cur_scale: torch.Tensor           # float32
    cur_iter: torch.Tensor            # int32
    last_overflow_iter: torch.Tensor  # int32
    cur_hysteresis: torch.Tensor      # int32


def init_dynamic_scaler_state(init_scale=2**32, delayed_shift=1, device=None):
    i32 = lambda x: torch.tensor(x, dtype=torch.int32, device=device)
    return DynamicScalerState(
        cur_scale=torch.tensor(init_scale, dtype=torch.float32, device=device),
        cur_iter=i32(0), last_overflow_iter=i32(-1), cur_hysteresis=i32(delayed_shift))


def update_scaler(state, overflow, *, scale_factor=2.0, scale_window=1000, min_scale=1.0,
                  delayed_shift=1, consecutive_hysteresis=False):
    """The next scaler state given whether this step overflowed (a bool or
    a device bool): on overflow back off by ``scale_factor`` once the
    hysteresis budget is spent, after ``scale_window`` clean steps grow by
    it. Branchless, so ``overflow`` may stay on the device."""
    overflow = torch.as_tensor(overflow, dtype=torch.bool, device=state.cur_scale.device)
    exhausted = (state.cur_hysteresis <= 1) | (delayed_shift == 1)
    backoff_scale = torch.clamp(state.cur_scale / scale_factor, min=min_scale)
    of_scale = torch.where(exhausted, backoff_scale, state.cur_scale)
    of_hysteresis = torch.where(exhausted, state.cur_hysteresis, state.cur_hysteresis - 1)

    window_elapsed = ((state.cur_iter - state.last_overflow_iter) % scale_window) == 0
    ok_scale = torch.where(window_elapsed, state.cur_scale * scale_factor, state.cur_scale)
    shift = torch.full_like(state.cur_hysteresis, delayed_shift)
    if consecutive_hysteresis:
        # only consecutive overflows draw the budget down: every clean step
        # refills it
        ok_hysteresis = shift
    else:
        ok_hysteresis = torch.where(window_elapsed, shift, state.cur_hysteresis)

    return DynamicScalerState(
        cur_scale=torch.where(overflow, of_scale, ok_scale),
        cur_iter=state.cur_iter + 1,
        last_overflow_iter=torch.where(overflow, state.cur_iter, state.last_overflow_iter),
        cur_hysteresis=torch.where(overflow, of_hysteresis, ok_hysteresis).to(torch.int32))


def advance_scaler(state, overflow, dynamic, scaler_kwargs=None):
    """One step of the scaler: the dynamic state machine, or (static
    scale) just the iteration counter."""
    if dynamic:
        return update_scaler(state, overflow, **(scaler_kwargs or {}))
    return state._replace(cur_iter=state.cur_iter + 1)


class LossScalerBase:
    def __init__(self, cur_scale):
        self.cur_scale = cur_scale

    @property
    def loss_scale(self):
        return self.cur_scale

    def scale_gradient(self, grads):
        return [g * self.loss_scale for g in grads]

    def update_scale(self, overflow):
        pass

    def backward(self, loss, retain_graph=False):
        """Backpropagate ``loss`` times the scale; returns the scaled loss."""
        scaled = loss * self.loss_scale
        scaled.backward(retain_graph=retain_graph)
        return scaled


class LossScaler(LossScalerBase):
    """Static loss scaler."""

    def __init__(self, scale=1):
        super().__init__(scale)

    def has_overflow(self, params):
        return False

    @staticmethod
    def _has_inf_or_nan(x):
        return False


class DynamicLossScaler(LossScalerBase):
    """Host-side dynamic loss scaler."""

    def __init__(self, init_scale=2**32, scale_factor=2.0, scale_window=1000, min_scale=1,
                 delayed_shift=1, consecutive_hysteresis=False):
        super().__init__(init_scale)
        self.cur_iter = 0
        self.last_overflow_iter = -1
        self.scale_factor = scale_factor
        self.scale_window = scale_window
        self.min_scale = min_scale
        self.delayed_shift = delayed_shift
        self.cur_hysteresis = delayed_shift
        self.consecutive_hysteresis = consecutive_hysteresis

    @staticmethod
    def _has_inf_or_nan(x):
        s = float(torch.as_tensor(x).double().sum())
        return s in (float("inf"), -float("inf")) or s != s

    def has_overflow_serial(self, params):
        return any(self._has_inf_or_nan(p) for p in params)

    has_overflow = has_overflow_serial

    def update_scale(self, overflow):
        if overflow:
            if self.delayed_shift == 1 or self.cur_hysteresis == 1:
                self.cur_scale = max(self.cur_scale / self.scale_factor, self.min_scale)
            else:
                self.cur_hysteresis -= 1
            self.last_overflow_iter = self.cur_iter
        else:
            if self.consecutive_hysteresis:
                self.cur_hysteresis = self.delayed_shift
            if (self.cur_iter - self.last_overflow_iter) % self.scale_window == 0:
                if not self.consecutive_hysteresis:
                    self.cur_hysteresis = self.delayed_shift
                self.cur_scale *= self.scale_factor
        self.cur_iter += 1


def CreateLossScaler(static_loss_scale=None, dynamic_scaling=False, dynamic_loss_args=None):
    """The scaler the reference engine would pick."""
    if dynamic_scaling:
        if dynamic_loss_args is None:
            return DynamicLossScaler()
        return DynamicLossScaler(
            init_scale=dynamic_loss_args.get(INITIAL_LOSS_SCALE, 2**32),
            scale_window=dynamic_loss_args.get(SCALE_WINDOW, 1000),
            delayed_shift=dynamic_loss_args.get(DELAYED_SHIFT, 1),
            min_scale=dynamic_loss_args.get(MIN_LOSS_SCALE, 1))
    return LossScaler(scale=static_loss_scale if static_loss_scale else 1.0)
