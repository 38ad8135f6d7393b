"""Runtime helpers: overflow check (device flag and ``CheckOverflow``),
global norm, gradient clipping, and seed folding.

Port of ``deepspeed_tpu/runtime/utils.py`` (:29-113) over lists of
tensors instead of pytrees, plus ``fold_seed``, which plays the part of
``jax.random.fold_in`` for the port's integer seeds.
"""

import math

import torch

_MASK64 = (1 << 64) - 1


def _splitmix64(x):
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def fold_seed(seed, *ids):
    """A 63-bit seed derived from ``seed`` and the integers ``ids`` (the
    microbatch, the layer, a stream within the layer): distinct ids give
    unrelated seeds, and the same arguments always give the same seed."""
    x = int(seed) & _MASK64
    for i in ids:
        x = _splitmix64(x ^ _splitmix64(int(i) & _MASK64))
    return x >> 1


def has_overflow(tensors):
    """A device bool: does any tensor hold an inf or a nan?"""
    tensors = list(tensors)
    if not tensors:
        return torch.tensor(False)
    flags = [~torch.isfinite(t).all() for t in tensors]
    return torch.stack(flags).any()


class CheckOverflow:
    """Host-side overflow checker over a list of tensors (``CheckOverflow``
    of the JAX package): one host read of the device flag a check."""

    def __init__(self, param_groups=None, mpu=None):
        self.mpu = mpu
        self.params = param_groups

    def check_using_norm(self, norm_group):
        norms = [float(n) for n in norm_group]
        return -1 in norms or any(not math.isfinite(n) for n in norms)

    def check(self, param_groups=None):
        return self.has_overflow(param_groups if param_groups is not None else self.params)

    def has_overflow(self, params):
        return bool(has_overflow(params))


def global_norm(tensors):
    """L2 norm over all tensors, accumulated in fp32 (a device scalar)."""
    tensors = list(tensors)
    if not tensors:
        return torch.tensor(0.0)
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


def clip_grad_norm_(grads, max_norm, global_grad_norm=None):
    """Scale ``grads`` in place so their global norm is at most
    ``max_norm``; returns the norm before clipping. A non-finite norm
    leaves the gradients unclipped (a NaN coefficient would poison every
    gradient) and is returned for the caller to act on."""
    total_norm = global_norm(grads) if global_grad_norm is None else global_grad_norm
    clip_coef = torch.where(torch.isfinite(total_norm),
                            torch.clamp(max_norm / (total_norm + 1e-6), max=1.0),
                            torch.ones_like(total_norm))
    torch._foreach_mul_(list(grads), clip_coef)
    return total_norm
