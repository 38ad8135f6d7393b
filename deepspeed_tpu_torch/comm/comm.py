"""Host-side control collectives with a deadline.

Port of ``deepspeed_tpu/comm/comm.py``: ``barrier`` and
``host_allreduce_scalar``, each bounded by ``_deadline_call``, and the
tensor collectives of the JAX module (``all_reduce``, ``all_gather``,
``reduce_scatter``, ``broadcast``, ``all_to_all``, ``ppermute_send_recv``),
which take a ``torch.distributed`` process group where the JAX ones take a
mesh axis name. A group of ``None`` is a group of one process: every
collective then returns its input. The gathers and scatters are tiled as
``jax.lax``'s ``tiled=True`` forms: the ranks' parts are concatenated
along one dimension, or a dimension is cut into as many parts.

A gloo group moves CUDA tensors through host memory: the collective runs
on a CPU copy, and the result is copied back to the card. That is chosen
by the group's backend, never by catching an error, and it is counted in
``HOST_STAGED`` (calls and bytes), so a run can say which of its
collectives went that way. NCCL groups take the card's tensors directly.

The autograd forms of the Megatron regions (``copy_to_model_region``,
``reduce_from_model_region``, ``gather_from_model_region``,
``scatter_to_model_region``) and a differentiable ``all_to_all`` are the
collectives tensor, sequence and expert parallelism call in a forward.

A thread blocked in an NCCL collective cannot be cancelled, and a rank
whose peer died leaves NCCL communicators that cannot be repaired. So the
control collectives never touch the NCCL group: they run on a gloo group
created beside it (``control_group``, made at the first control call
over a default group, collectively) on a daemon worker, and the caller
waits on a result queue. When the deadline passes the caller gets a
``CommTimeoutError``; the worker is abandoned, and a process with a
group running marks its groups unusable: every later control call
raises ``CommError`` at once, since a collective behind a wedged one
would pair with the wrong peers. The error unwinds to the worker
supervisor (``launcher/supervisor.py``), which restarts the whole local
group.

The abandoned worker is a daemon thread: the interpreter does not wait
for it at exit. If it is blocked inside gloo, the process group's own
timeout (30 minutes by default) ends the wait at the latest; a process
that does not exit meanwhile stops beating its heartbeat, and the
supervisor kills it (SIGTERM, then SIGKILL after the grace period).

With no process group (one process), ``barrier`` synchronizes the card
and ``host_allreduce_scalar`` returns its input; the deadline still
applies.
"""

import queue
import threading
from enum import Enum

import torch

from deepspeed_tpu_torch.comm.errors import (  # noqa: F401 (re-exported)
    CommError,
    CommTimeoutError,
    DeadPeerError,
)


class ReduceOp(Enum):
    SUM = "sum"
    AVG = "avg"
    MAX = "max"
    MIN = "min"
    PRODUCT = "product"


_lock = threading.Lock()
_control = (None, None)   # (the default group, the gloo group beside it)
_wedged = None            # what timed out, once a deadline has passed


def _group_running():
    return torch.distributed.is_available() and torch.distributed.is_initialized()


def control_group():
    """The gloo group over every rank of the default group, created at the
    first call over that group (a collective: every rank reaches it at
    its first control call). The default group itself when it is gloo
    already."""
    global _control
    with _lock:
        world = torch.distributed.group.WORLD
        if _control[0] is not world:
            gloo = (world if torch.distributed.get_backend() == "gloo"
                    else torch.distributed.new_group(backend="gloo"))
            _control = (world, gloo)
        return _control[1]


def _deadline_call(fn, timeout_s, what):
    """Run a blocking host-level call with a wall-clock deadline. The
    call runs on a daemon worker and the caller waits on a result queue:
    on expiry the worker is abandoned and a named ``CommTimeoutError``
    surfaces instead of an eternal hang (the resilience watchdog's
    inversion). A process with a group, where a deadline has passed,
    refuses further control calls."""
    global _wedged
    if _wedged is not None:
        raise CommError(f"{what}: refused, '{_wedged}' timed out earlier in this process; "
                        "its groups cannot be used again (restart the worker)")
    if timeout_s is None or timeout_s <= 0:
        return fn()
    out = queue.Queue(maxsize=1)

    def run():
        try:
            out.put(("ok", fn()))
        except BaseException as e:  # noqa: BLE001 (re-raised on the caller side)
            out.put(("err", e))

    threading.Thread(target=run, daemon=True, name=f"comm-deadline:{what}").start()
    try:
        kind, val = out.get(timeout=timeout_s)
    except queue.Empty:
        if _group_running():
            _wedged = what
        raise CommTimeoutError(what=what, timeout_s=timeout_s) from None
    if kind == "err":
        raise val
    return val


def _injected_hang():
    """Cluster fault-injection seam (the hang_barrier arm); a no-op outside
    fault-injection runs. Imported late: comm must not depend on the
    runtime package at import time."""
    from deepspeed_tpu_torch.runtime.resilience.cluster_faults import get_active_injector

    inj = get_active_injector()
    if inj is not None:
        inj.maybe_hang_barrier()


def _current_cuda_device():
    """The caller's card, when this process has started CUDA (the worker
    thread's own current device would be card 0)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        return torch.cuda.current_device()
    return None


def barrier(name="dstorch_barrier", timeout_s=None):
    """Cross-process barrier: finish the card's queued work, then meet every
    rank on the control group (with a group running). ``timeout_s``
    bounds the wait: a barrier a dead or wedged peer never joins raises
    ``CommTimeoutError`` within the deadline. None or 0 waits without
    bound."""
    device = _current_cuda_device()

    def sync():
        _injected_hang()
        if device is not None:
            torch.cuda.synchronize(device)
        if _group_running():
            torch.distributed.barrier(group=control_group())

    return _deadline_call(sync, timeout_s, what=f"barrier '{name}'")


def host_allreduce_scalar(value, timeout_s=None):
    """Sum of a host scalar over the ranks (fp32, as the JAX package's),
    on the control group; ``value`` itself with no group. ``timeout_s``
    bounds the wait, as in ``barrier``."""

    def reduce():
        _injected_hang()
        if not _group_running():
            return value
        t = torch.tensor([value], dtype=torch.float32)
        torch.distributed.all_reduce(t, group=control_group())
        return float(t[0])

    return _deadline_call(reduce, timeout_s, what="host_allreduce_scalar")


def forget_timeout():
    """Accept control calls again after a deadline passed: only for a
    process that has torn its groups down and started new ones."""
    global _wedged
    _wedged = None


# ---------------------------------------------------------------------------
# tensor collectives over a process group (the JAX module's axis-name ones)
# ---------------------------------------------------------------------------

# collectives a gloo group ran on host copies of CUDA tensors
HOST_STAGED = {"calls": 0, "bytes": 0}

_TORCH_OPS = {ReduceOp.SUM: "SUM", ReduceOp.AVG: "SUM", ReduceOp.MAX: "MAX",
              ReduceOp.MIN: "MIN", ReduceOp.PRODUCT: "PRODUCT"}


def group_size(group):
    """Members of ``group`` (1 for ``None``)."""
    return 1 if group is None else torch.distributed.get_world_size(group)


def group_rank(group):
    """This process's index in ``group`` (0 for ``None``)."""
    return 0 if group is None else torch.distributed.get_rank(group)


def _staged(group, *tensors):
    """True when ``group`` is gloo and a tensor lies on the card: the
    collective then runs on host copies (counted in ``HOST_STAGED``)."""
    if torch.distributed.get_backend(group) != "gloo" or \
            not any(t.device.type == "cuda" for t in tensors):
        return False
    HOST_STAGED["calls"] += 1
    HOST_STAGED["bytes"] += sum(t.numel() * t.element_size() for t in tensors)
    return True


def _run(group, fn, inputs, outputs):
    """``fn(inputs, outputs)`` on the card's tensors, or on host copies for
    a gloo group (outputs copied back)."""
    if not _staged(group, *inputs, *outputs):
        fn(inputs, outputs)
        return
    host_in = [t.cpu() for t in inputs]
    host_out = [torch.empty(t.shape, dtype=t.dtype) for t in outputs]
    fn(host_in, host_out)
    for t, h in zip(outputs, host_out):
        t.copy_(h)


def all_reduce(x, group, op=ReduceOp.SUM):
    """The reduction of ``x`` over ``group`` (a new tensor; AVG divides
    the sum by the group's size)."""
    n = group_size(group)
    if n == 1:
        return x.clone()
    out = x.detach().clone().contiguous()
    red = getattr(torch.distributed.ReduceOp, _TORCH_OPS[op])
    buf = out.cpu() if _staged(group, out) else out
    torch.distributed.all_reduce(buf, op=red, group=group)
    if buf is not out:
        out.copy_(buf)
    return out / n if op == ReduceOp.AVG else out


def all_gather(x, group, axis=0):
    """The ranks' ``x`` concatenated along ``axis`` in rank order."""
    n = group_size(group)
    if n == 1:
        return x.clone()
    x = x.detach().movedim(axis, 0).contiguous()
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    _run(group, lambda i, o: torch.distributed.all_gather_into_tensor(o[0], i[0], group=group),
         [x], [out])
    return out.movedim(0, axis)


def reduce_scatter(x, group, scatter_dimension=0):
    """The sum of ``x`` over ``group``, cut into as many parts along
    ``scatter_dimension``; this rank's part."""
    n = group_size(group)
    if n == 1:
        return x.clone()
    x = x.detach().movedim(scatter_dimension, 0).contiguous()
    if x.shape[0] % n:
        raise ValueError(f"reduce_scatter: dim of {x.shape[0]} does not split {n} ways")
    out = torch.empty((x.shape[0] // n,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    _run(group, lambda i, o: torch.distributed.reduce_scatter_tensor(o[0], i[0], group=group),
         [x], [out])
    return out.movedim(0, scatter_dimension)


def broadcast(x, group, root=0):
    """Every rank takes the ``x`` of group rank ``root``."""
    n = group_size(group)
    if not 0 <= int(root) < n:
        raise ValueError(f"broadcast root {root} is not a valid index in a group of {n}")
    if n == 1:
        return x.clone()
    out = x.detach().clone().contiguous()
    src = torch.distributed.get_global_rank(group, int(root))
    if _staged(group, out):
        host = out.cpu()
        torch.distributed.broadcast(host, src=src, group=group)
        out.copy_(host)
    else:
        torch.distributed.broadcast(out, src=src, group=group)
    return out


def broadcast_object(obj, group, root=0):
    """Every rank takes the picklable ``obj`` of group rank ``root`` (a
    host-side collective: ``group`` is a gloo group, such as the control
    group)."""
    if group_size(group) == 1:
        return obj
    box = [obj]
    torch.distributed.broadcast_object_list(
        box, src=torch.distributed.get_global_rank(group, int(root)), group=group)
    return box[0]


def all_to_all(x, group, split_axis, concat_axis):
    """``jax.lax.all_to_all(..., tiled=True)``: ``split_axis`` is cut into
    as many parts as ranks, part j goes to rank j, and the parts received
    are concatenated along ``concat_axis`` in rank order."""
    n = group_size(group)
    if n == 1:
        return x.clone()
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: dim of {x.shape[split_axis]} does not split {n} ways")
    send = torch.stack(x.detach().chunk(n, dim=split_axis)).contiguous()
    out = torch.empty_like(send)
    _run(group, lambda i, o: torch.distributed.all_to_all_single(o[0], i[0], group=group),
         [send], [out])
    # out[j] is the part rank j sent here
    return torch.cat(list(out.unbind(0)), dim=concat_axis)


def ppermute_send_recv(x, group, shift=1):
    """Ring shift: group rank i's ``x`` goes to rank (i + shift) mod n;
    returns what this rank received."""
    n = group_size(group)
    if n == 1 or shift % n == 0:
        return x.clone()
    me = group_rank(group)
    dst = torch.distributed.get_global_rank(group, (me + shift) % n)
    src = torch.distributed.get_global_rank(group, (me - shift) % n)
    send = x.detach().contiguous()
    recv = torch.empty_like(send)
    staged = _staged(group, send, recv)
    s_buf, r_buf = (send.cpu(), torch.empty(send.shape, dtype=send.dtype)) if staged \
        else (send, recv)
    ops = [torch.distributed.P2POp(torch.distributed.isend, s_buf, dst, group=group),
           torch.distributed.P2POp(torch.distributed.irecv, r_buf, src, group=group)]
    for req in torch.distributed.batch_isend_irecv(ops):
        req.wait()
    if staged:
        recv.copy_(r_buf)
    return recv


# ---------------------------------------------------------------------------
# autograd forms: the Megatron regions and the all-to-all
# ---------------------------------------------------------------------------

def split_sections(x, group, sections=1):
    """This rank's part of ``x``'s last dim, cut into ``sections`` equal
    sections first and each section into as many parts as ranks."""
    n, r = group_size(group), group_rank(group)
    parts = x.reshape(*x.shape[:-1], sections, n, x.shape[-1] // (sections * n))
    return parts[..., r, :].reshape(*x.shape[:-1], x.shape[-1] // n).contiguous()


def gather_sections(x, group, sections=1):
    """Inverse of ``split_sections``: the ranks' parts of the last dim put
    back section by section."""
    n = group_size(group)
    g = all_gather(x.contiguous(), group, axis=0)        # [n * d0, ..., m]
    g = g.reshape(n, *x.shape[:-1], sections, x.shape[-1] // sections)
    g = g.movedim(0, -2)                                  # [..., sections, n, m/s]
    return g.reshape(*x.shape[:-1], x.shape[-1] * n)


class _CopyToRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _ReduceFromRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, sections):
        ctx.group, ctx.sections = group, sections
        return gather_sections(x, group, sections)

    @staticmethod
    def backward(ctx, g):
        return split_sections(g, ctx.group, ctx.sections), None, None


class _ScatterToRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return split_sections(x, group)

    @staticmethod
    def backward(ctx, g):
        return gather_sections(g, ctx.group), None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis):
        ctx.args = (group, split_axis, concat_axis)
        return all_to_all(x, group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        group, split_axis, concat_axis = ctx.args
        return all_to_all(g, group, concat_axis, split_axis), None, None, None


def copy_to_model_region(x, group):
    """Identity forward, all-reduce backward: the input of a
    column-parallel product, whose gradient is each rank's partial sum."""
    return x if group_size(group) == 1 else _CopyToRegion.apply(x, group)


def reduce_from_model_region(x, group):
    """All-reduce forward, identity backward: the output of a row-parallel
    product (or a vocab-parallel lookup)."""
    return x if group_size(group) == 1 else _ReduceFromRegion.apply(x, group)


def gather_from_model_region(x, group, sections=1):
    """The last dim all-gathered (section by section, for a fused output
    whose ``sections`` are split alike); the backward takes this rank's
    part."""
    return x if group_size(group) == 1 else _GatherFromRegion.apply(x, group, sections)


def scatter_to_model_region(x, group):
    """This rank's part of the last dim; the backward all-gathers."""
    return x if group_size(group) == 1 else _ScatterToRegion.apply(x, group)


def all_to_all_autograd(x, group, split_axis, concat_axis):
    """``all_to_all`` whose backward is the inverse all-to-all."""
    if group_size(group) == 1:
        return x
    return _AllToAll.apply(x, group, split_axis, concat_axis)
