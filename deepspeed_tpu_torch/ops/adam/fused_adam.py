"""Fused Adam/AdamW over lists of fp32 tensors.

Port of ``deepspeed_tpu/ops/adam/fused_adam.py``: the same hyper-parameters,
bias correction, AdamW decoupled decay, and ``no_decay_names`` matched on
parameter names. The optimizer keeps the JAX package's functional shape
(``init`` -> state, ``update(grads, state, params, lr)``) but updates the
fp32 params and the fp32 state in place, a tensor list at a time with
``torch._foreach_*`` ops (the JAX package left this elementwise math to
XLA's fusion; a hand-written multi-tensor kernel is later work).
"""

from dataclasses import dataclass, field

import numpy as np
import torch


@dataclass
class AdamState:
    step: int = 0
    exp_avg: list = field(default_factory=list)
    exp_avg_sq: list = field(default_factory=list)


def decay_scales(names, no_decay_names):
    """Per-parameter weight-decay multipliers (1.0 / 0.0): 0 where the
    name contains any of ``no_decay_names`` (case-insensitive)."""
    subs = [s.lower() for s in no_decay_names]
    return [0.0 if any(s in n.lower() for s in subs) else 1.0 for n in names]


class FusedAdam:
    def __init__(self, lr=1e-3, bias_correction=True, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=0.0, adam_w_mode=True, amsgrad=False, no_decay_names=None,
                 **kwargs):
        if amsgrad:
            raise RuntimeError("FusedAdam does not support the AMSGrad variant.")
        self.lr = lr
        self.bias_correction = bias_correction
        self.betas = tuple(betas)
        self.eps = eps
        self.weight_decay = weight_decay
        self.adam_w_mode = adam_w_mode
        self.no_decay_names = list(no_decay_names or [])

    @property
    def name(self):
        return "adamw" if self.adam_w_mode else "adam"

    def init(self, params):
        zeros = lambda: [torch.zeros_like(p, dtype=torch.float32) for p in params]
        return AdamState(step=0, exp_avg=zeros(), exp_avg_sq=zeros())

    def update(self, grads, state, params, lr=None, names=None):
        """One step on fp32 ``params`` (updated in place) from ``grads``;
        ``names`` (one per param) select the weight-decay exemptions.
        Returns (params, state)."""
        lr = self.lr if lr is None else float(lr)
        beta1, beta2 = self.betas
        wd = self.weight_decay
        state.step += 1
        step = np.float32(state.step)
        params, grads = list(params), [g.float() for g in grads]
        m, v = state.exp_avg, state.exp_avg_sq
        if wd != 0.0:
            scales = (decay_scales(names, self.no_decay_names)
                      if self.no_decay_names and names is not None else [1.0] * len(params))
            decayed = [p * (wd * s) for p, s in zip(params, scales)]
        if wd != 0.0 and not self.adam_w_mode:
            grads = torch._foreach_add(grads, decayed)
        torch._foreach_mul_(m, beta1)
        torch._foreach_add_(m, grads, alpha=1 - beta1)
        torch._foreach_mul_(v, beta2)
        torch._foreach_addcmul_(v, grads, grads, value=1 - beta2)
        if self.bias_correction:
            # in fp32, as the JAX update computes beta**step
            bc1 = float(np.float32(1) - np.float32(beta1) ** step)
            bc2 = float(np.float32(1) - np.float32(beta2) ** step)
            denom = torch._foreach_div(v, bc2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, self.eps)
            update = torch._foreach_div(m, bc1)
        else:
            denom = torch._foreach_sqrt(v)
            torch._foreach_add_(denom, self.eps)
            update = [t.clone() for t in m]
        torch._foreach_div_(update, denom)
        if wd != 0.0 and self.adam_w_mode:
            torch._foreach_add_(update, decayed)
        torch._foreach_add_(params, update, alpha=-lr)
        return params, state
