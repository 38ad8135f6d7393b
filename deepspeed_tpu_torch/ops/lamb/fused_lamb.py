"""Fused LAMB over lists of fp32 tensors.

Port of ``deepspeed_tpu/ops/lamb/fused_lamb.py``: Adam's moments, then a
per-tensor trust ratio ||w|| / ||update|| clamped to [min_coeff,
max_coeff] (1 where either norm is 0) scales each tensor's step. The JAX
package leaves this elementwise math and the two norms of each tensor to
XLA's fusion; the port runs it as ``torch._foreach_*`` passes over the
tensor list, the norms from ``torch._foreach_norm``, all on the device and
in place, with no host read.

Under ZeRO the JAX package runs LAMB over the flat fp32 master, so one
trust ratio covers every parameter (``jnp.sum`` over a sharded array is
global). ``update(..., sum_sq=fn)`` does that: the two squared norms are
summed over every tensor of the list and then by ``fn`` over the ranks,
and one clamped ratio scales every tensor's step.
"""

from dataclasses import dataclass, field

import numpy as np
import torch


@dataclass
class LambState:
    step: int = 0
    exp_avg: list = field(default_factory=list)
    exp_avg_sq: list = field(default_factory=list)


class FusedLamb:
    def __init__(self, lr=1e-3, bias_correction=True, betas=(0.9, 0.999), eps=1e-8,
                 eps_inside_sqrt=False, weight_decay=0.0, max_grad_norm=0.0, max_coeff=10.0,
                 min_coeff=0.01, amsgrad=False, **kwargs):
        if amsgrad:
            raise RuntimeError("FusedLamb does not support the AMSGrad variant.")
        if kwargs.get("no_decay_names"):
            raise ValueError("no_decay_names is only supported by Adam/AdamW (FusedAdam)")
        self.lr = lr
        self.bias_correction = bias_correction
        self.betas = tuple(betas)
        self.eps = eps
        self.eps_inside_sqrt = eps_inside_sqrt
        self.weight_decay = weight_decay
        self.max_coeff = max_coeff
        self.min_coeff = min_coeff

    @property
    def name(self):
        return "lamb"

    def init(self, params):
        zeros = lambda: [torch.zeros_like(p, dtype=torch.float32) for p in params]
        return LambState(step=0, exp_avg=zeros(), exp_avg_sq=zeros())

    def update(self, grads, state, params, lr=None, names=None, sum_sq=None):
        """One step on fp32 ``params`` (updated in place) from ``grads``;
        with ``sum_sq`` (a function summing a tensor of squared norms over
        the ranks) one trust ratio over all of them. Returns (params,
        state)."""
        lr = self.lr if lr is None else float(lr)
        beta1, beta2 = self.betas
        state.step += 1
        step = np.float32(state.step)
        params, grads = list(params), [g.float() for g in grads]
        m, v = state.exp_avg, state.exp_avg_sq
        torch._foreach_mul_(m, beta1)
        torch._foreach_add_(m, grads, alpha=1 - beta1)
        torch._foreach_mul_(v, beta2)
        torch._foreach_addcmul_(v, grads, grads, value=1 - beta2)
        if self.bias_correction:
            # in fp32, as the JAX update computes beta**step
            m_hat = torch._foreach_div(m, float(np.float32(1) - np.float32(beta1) ** step))
            v_hat = torch._foreach_div(v, float(np.float32(1) - np.float32(beta2) ** step))
        else:
            m_hat, v_hat = m, v
        if self.eps_inside_sqrt:
            denom = torch._foreach_add(v_hat, self.eps)
            torch._foreach_sqrt_(denom)
        else:
            denom = torch._foreach_sqrt(v_hat)
            torch._foreach_add_(denom, self.eps)
        update = torch._foreach_div(m_hat, denom)
        if self.weight_decay != 0.0:
            torch._foreach_add_(update, params, alpha=self.weight_decay)
        # the trust ratio of each tensor, clamped, 1 where a norm is 0
        w_norm = torch.stack(torch._foreach_norm(params))
        u_norm = torch.stack(torch._foreach_norm(update))
        if sum_sq is not None:   # one ratio over the flat master
            sq = sum_sq(torch.stack([w_norm.square().sum(), u_norm.square().sum()]))
            w_norm, u_norm = sq.sqrt().unbind()
            w_norm = w_norm.expand(len(params))
            u_norm = u_norm.expand(len(params))
        trust = torch.where((w_norm > 0) & (u_norm > 0),
                            torch.clamp(w_norm / u_norm, self.min_coeff, self.max_coeff),
                            torch.ones_like(w_norm))
        torch._foreach_mul_(update, list((trust * lr).unbind()))
        torch._foreach_sub_(params, update)
        return params, state
