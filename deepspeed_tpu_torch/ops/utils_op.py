"""Flat layout helpers over an ordered list of tensors.

Port of ``deepspeed_tpu/ops/utils_op.py`` (``tree_spec``,
``flatten_dense_tensors``, ``unflatten_dense_tensors``,
``pad_to_multiple``) for the engine's ordered parameter list: ZeRO keeps
the parameters, their gradients and the fp32 master as one flat vector
each. ``align`` starts every tensor at a multiple of that many elements
(zeros in between; 1 is the JAX package's plain concatenation), so that a
parameter viewed out of a flat buffer keeps the alignment it would have as
a tensor of its own. ``unflatten_dense_tensors`` returns views: the
module's parameters can alias one flat buffer.
"""

import math

import torch


def tree_spec(tensors):
    """(shapes, dtypes, sizes) of an ordered list of tensors."""
    shapes = [tuple(t.shape) for t in tensors]
    dtypes = [t.dtype for t in tensors]
    sizes = [math.prod(s) for s in shapes]
    return shapes, dtypes, sizes


def flat_offsets(sizes, align=1):
    """Each tensor's start in the flat vector, and the vector's length."""
    offsets, end = [], 0
    for n in sizes:
        end = -(-end // align) * align
        offsets.append(end)
        end += n
    return offsets, end


def flatten_dense_tensors(tensors, dtype=torch.float32, align=1):
    """One flat 1-D tensor of ``dtype`` holding every tensor in order."""
    offsets, n = flat_offsets([t.numel() for t in tensors], align)
    device = tensors[0].device if tensors else None
    out = torch.zeros(n, dtype=dtype, device=device)
    for t, off in zip(tensors, offsets):
        out[off:off + t.numel()].copy_(t.reshape(-1))
    return out


def unflatten_dense_tensors(flat, shapes, align=1):
    """Views of ``flat`` with the given shapes, in order (the inverse of
    ``flatten_dense_tensors``)."""
    offsets, n = flat_offsets([math.prod(s) for s in shapes], align)
    assert flat.numel() >= n, f"flat vector of {flat.numel()} < {n} elements"
    return [flat[off:off + math.prod(s)].view(s) for off, s in zip(offsets, shapes)]


def pad_to_multiple(flat, multiple):
    """Zero-pad a flat tensor so its length divides ``multiple``; returns
    (padded, original length)."""
    n = flat.shape[0]
    padded = -(-n // multiple) * multiple if n else multiple
    if padded != n:
        flat = torch.cat([flat, flat.new_zeros(padded - n)])
    return flat, n
