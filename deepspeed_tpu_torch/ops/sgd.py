"""Plain SGD with momentum, Nesterov and weight decay over lists of fp32
tensors (port of ``deepspeed_tpu/ops/sgd.py``, the engine's ``SGD``
optimizer), updated in place with ``torch._foreach_*`` passes."""

from dataclasses import dataclass, field

import torch


@dataclass
class SGDState:
    step: int = 0
    momentum_buf: list = field(default_factory=list)


class SGD:
    def __init__(self, lr=1e-3, momentum=0.0, weight_decay=0.0, nesterov=False, **kwargs):
        if kwargs.get("no_decay_names"):
            raise ValueError("no_decay_names is only supported by Adam/AdamW (FusedAdam)")
        self.lr = lr
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.nesterov = nesterov

    @property
    def name(self):
        return "sgd"

    def init(self, params):
        return SGDState(step=0, momentum_buf=[torch.zeros_like(p, dtype=torch.float32)
                                              for p in params])

    def update(self, grads, state, params, lr=None, names=None):
        """One step on fp32 ``params`` (updated in place); the momentum
        buffer holds the last direction (the gradient itself without
        momentum, as in the JAX package). Returns (params, state)."""
        lr = self.lr if lr is None else float(lr)
        params = list(params)
        g = [t.float() for t in grads]
        if self.weight_decay:
            g = torch._foreach_add(g, params, alpha=self.weight_decay)
        buf = state.momentum_buf
        if self.momentum:
            torch._foreach_mul_(buf, self.momentum)
            torch._foreach_add_(buf, g)
        else:
            torch._foreach_copy_(buf, g)
        direction = torch._foreach_add(g, buf, alpha=self.momentum) if self.nesterov else buf
        torch._foreach_add_(params, direction, alpha=-lr)
        state.step += 1
        return params, state
