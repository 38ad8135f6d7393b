"""Activation checkpointing (rematerialization) policies.

Port of ``resolve_remat_policy`` of
``deepspeed_tpu/runtime/activation_checkpointing/checkpointing.py``:

- ``"nothing"``: save nothing, recompute the whole layer in backward (a
  plain non-reentrant ``torch.utils.checkpoint``);
- ``"dots"``: save the outputs of the non-batched matmuls (``aten.mm`` and
  ``aten.addmm``, what ``dots_with_no_batch_dims_saveable`` saves in JAX)
  and recompute the rest, through selective checkpointing.

Under both, the attention kernel (not a matmul) is recomputed. The global
RNG state is not stashed: the port's layers draw their dropout from
explicit generators seeded by an argument, which the recompute passes
again.
"""

import functools

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

REMAT_POLICIES = ("nothing", "dots")
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def resolve_remat_policy(name):
    """checkpoint_policy name -> the ``context_fn`` for
    ``torch.utils.checkpoint`` (None: save nothing)."""
    if name == "offload_dots":
        raise NotImplementedError(
            "checkpoint_policy 'offload_dots' (cpu_checkpointing) is not ported yet")
    if name not in REMAT_POLICIES:
        raise ValueError(f"checkpoint_policy must be one of {REMAT_POLICIES}, got {name!r}")
    if name == "dots":
        return functools.partial(create_selective_checkpoint_contexts, _dots_policy)
    return None


def checkpoint_call(function, *args, policy="nothing", **kwargs):
    """``function(*args, **kwargs)``, recomputed in backward under ``policy``."""
    context_fn = resolve_remat_policy(policy)
    extra = {} if context_fn is None else {"context_fn": context_fn}
    return checkpoint(function, *args, use_reentrant=False, preserve_rng_state=False,
                      **extra, **kwargs)
