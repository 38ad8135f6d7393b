"""ZeRO stages 1-3 and ZeRO-Offload over one flat fp32 master.

Port of ``deepspeed_tpu/runtime/zero/sharded_optimizer.py``. The JAX
package states ZeRO as shardings inside one XLA program; here the same
steps are explicit ``torch.distributed`` collectives over a flat layout
of the engine's ordered parameter list (``ops/utils_op.py``, each
parameter starting at a multiple of ``ALIGN`` elements, zeros between):

- the module's parameters are views of one flat compute-dtype buffer, and
  the engine accumulates gradients into views of one flat fp32 buffer;
- rank ``r`` of ``W`` owns ``[r * n / W, (r + 1) * n / W)`` of the padded
  flat vector: its slice of the fp32 master and of the optimizer state;
- stage 1 all-reduces the flat gradient and keeps its slice; stage 2
  reduce-scatters it (``reduce_scatter_tensor``); both then take the mean
  over the world, as the JAX package's global mean does;
- the inner optimizer steps this rank's slice, a list of views (one piece
  of each parameter the slice holds, so a one-rank run applies the very
  operations of the unsharded engine), and ``all_gather_into_tensor``
  rebuilds the flat parameters in the compute dtype;
- stage 3 stores each parameter whose dim 0 divides by the world as this
  rank's dim-0 shard between steps, gathers every parameter at the step's
  first forward (and keeps it through the backward's recompute) and
  re-shards it after the update;
- ``overlap_comm`` reduces the gradients a bucket at a time
  (``compute_bucket_ranges``), each bucket's all-reduce issued from
  ``Tensor.register_post_accumulate_grad_hook`` as its last gradient
  lands, at ``gradient_accumulation_steps`` 1;
- ``cpu_offload`` keeps the master and the Adam state in host memory only
  and steps them with the host Adam kernel (``DeepSpeedCPUAdam``):
  gradients go D2H into pinned buffers on a side stream, and the updated
  parameters go H2D on another, sequentially or streamed a bucket at a
  time through two worker threads (``offload_stream_buckets`` >= 2). The
  copies run inside the named transfer windows ``zero/offload_d2h`` and
  ``zero/offload_h2d``, and are made of what a transfer guard
  (``profiling/sentinels.py: transfer_free``) lets through on any thread:
  ``non_blocking`` copies, events and ``Event.synchronize``;
- ``shard_state_dict`` saves this rank's slice of the master and the
  optimizer state as its checkpoint shard (unpadded, with ``rank``,
  ``dp_world_size`` and ``numel``; a rank holds only its own slice, so
  it returns one shard where the JAX package's ``shard_state_dicts``
  returns every rank's), and ``load_shard_state_dicts`` merges the
  shards of a save at any dp degree, re-partitioned for this one,
  copying into the existing buffers.
"""

import dataclasses
import math
import queue
import threading
import time
from contextlib import nullcontext

import torch

from deepspeed_tpu_torch import telemetry
from deepspeed_tpu_torch.ops.utils_op import flat_offsets, unflatten_dense_tensors
from deepspeed_tpu_torch.profiling.sentinels import allowed_transfer, register_allowed_transfer
from deepspeed_tpu_torch.runtime.utils import global_norm, has_overflow
from deepspeed_tpu_torch.utils.distributed import group_rank_and_size
from deepspeed_tpu_torch.utils.logging import log_dist

# ZeRO-Offload's paging traffic: the only transfers a guarded step allows it
OFFLOAD_D2H = register_allowed_transfer("zero/offload_d2h")
OFFLOAD_H2D = register_allowed_transfer("zero/offload_h2d")

# the reference default; non-default bucket sizes that do nothing are logged
DEFAULT_BUCKET_SIZE = 500000000
# every parameter starts at a multiple of this many elements of the flat
# layout (512 bytes of bf16, 1 KiB of fp32): a parameter viewed out of a
# flat buffer starts at least as aligned as a tensor of its own, whose
# block PyTorch's CUDA allocator rounds to 512 bytes
ALIGN = 256


def compute_bucket_ranges(sizes, bucket_size):
    """Greedy split of the flat leaf order into contiguous buckets holding
    at most ``bucket_size`` elements each (a single oversized leaf still
    gets its own bucket: leaves are never split across buckets).

    Returns ``[(lo, hi), ...]`` half-open leaf-index ranges covering every
    leaf exactly once, in leaf order."""
    bucket_size = max(1, int(bucket_size))
    ranges = []
    start, acc = 0, 0
    for i, n in enumerate(sizes):
        n = max(1, int(n))
        if acc > 0 and acc + n > bucket_size:
            ranges.append((start, i))
            start, acc = i, 0
        acc += n
    if start < len(sizes):
        ranges.append((start, len(sizes)))
    return ranges


def zero3_param_shardings(shapes, world_size):
    """Stage 3's storage layout: for each parameter shape, whether it is
    stored as a dim-0 shard (dim 0 at least the world and divisible by
    it) or whole (its memory is negligible)."""
    return [len(s) >= 1 and s[0] >= world_size and s[0] % world_size == 0 for s in shapes]


def _span(tracer, name, bucket, numel):
    """An offload stage's span; disarmed, the shared no-op (no args dict
    is built)."""
    return tracer.span(name, cat="offload", args={"bucket": bucket, "numel": numel}) \
        if tracer.enabled else telemetry.NULL_SPAN


def _host_copy(t):
    """A compact CPU copy of ``t`` (a view saves only its own elements)."""
    return t.detach().to("cpu", copy=True)


def _offload_stage_loop(q):
    """The loop of an offload pipeline worker: tasks are closures that
    trap their own errors; ``None`` ends the worker."""
    while True:
        task = q.get()
        if task is None:
            return
        task()


class _Copies:
    """A side stream for the offload's copies, with events, on a CUDA
    device; on the CPU the copies run inline and there is nothing to wait
    for."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.stream = torch.cuda.Stream(device) if self.cuda else None

    def context(self):
        return torch.cuda.stream(self.stream) if self.cuda else nullcontext()

    def event(self):
        if not self.cuda:
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(self.stream)
        return ev

    def follow(self, other=None):
        """This stream waits for the work queued so far on ``other`` (the
        current stream when None)."""
        if self.cuda:
            self.stream.wait_stream(other or torch.cuda.current_stream(self.stream.device))

    def lead(self):
        """The current stream waits for the work queued so far on this one."""
        if self.cuda:
            torch.cuda.current_stream(self.stream.device).wait_stream(self.stream)


def _wait(ev):
    if ev is not None:
        ev.synchronize()


def _elapsed_ms(start, end, host_s):
    """Device time between two events of a stream, or the host's time."""
    return start.elapsed_time(end) if start is not None else host_s * 1e3


class ZeroShardedOptimizer:
    """The ZeRO optimizer: wraps an inner optimizer (``FusedAdam``,
    ``FusedLamb``, ``SGD``; ``DeepSpeedCPUAdam`` under offload)."""

    def __init__(self, inner, stage=1, cpu_offload=False, reduce_scatter=True,
                 reduce_bucket_size=DEFAULT_BUCKET_SIZE,
                 allgather_bucket_size=DEFAULT_BUCKET_SIZE, overlap_comm=False,
                 offload_stream_buckets=1, offload_pin_host=True,
                 compute_dtype=torch.float32, gradient_accumulation_steps=1):
        self.inner = inner
        self.stage = stage
        self.cpu_offload = cpu_offload
        self.offload_stream_buckets = max(1, int(offload_stream_buckets))
        self.offload_pin_host = bool(offload_pin_host)
        self._offload_streaming = bool(cpu_offload) and self.offload_stream_buckets > 1
        self.reduce_scatter = reduce_scatter
        self.reduce_bucket_size = reduce_bucket_size
        self.allgather_bucket_size = allgather_bucket_size
        self.compute_dtype = compute_dtype
        # a bucket's reduce is issued from the backward only when the last
        # gradient of a step lands in one backward (gas 1), and not under
        # offload, whose host step fetches the whole gradient
        self.overlap_comm = (overlap_comm and not cpu_offload
                             and gradient_accumulation_steps == 1)
        if self.overlap_comm:
            ignored = (("allgather_bucket_size", allgather_bucket_size),)
        else:
            ignored = (("reduce_bucket_size", reduce_bucket_size),
                       ("allgather_bucket_size", allgather_bucket_size))
        for knob, val in ignored:
            if val != DEFAULT_BUCKET_SIZE:
                log_dist(f"ZeRO: '{knob}'={val} is accepted for parity but IGNORED: the "
                         "parameters are gathered in one all_gather_into_tensor, and the "
                         "gradients reduced in one collective unless overlap_comm "
                         "buckets them", ranks=[0])
        if overlap_comm and not self.overlap_comm:
            why = ("the host step fetches the whole gradient" if cpu_offload else
                   "buckets are reduced from the backward only at "
                   "gradient_accumulation_steps 1")
            log_dist(f"ZeRO: overlap_comm is IGNORED here: {why}", ranks=[0])
        self._buckets = None       # [(lo, hi)] leaf ranges
        self.bucket_numels = None
        self._offload_queues = None
        self._offload_threads = None
        self._offload_master_next = None
        self._h2d_done = None      # the last H2D event of the previous step
        self.last_offload_stats = None
        self.name = getattr(inner, "name", "zero")

    # -- layout -----------------------------------------------------------
    def _full_fp32(self, i):
        """Parameter ``i``'s whole value in fp32 (gathered when it arrives
        as a stage-3 shard from ``zero3_sharded_init``)."""
        p = self._params[i]
        if getattr(p, "ds_shape", None) is None:
            return p.detach().reshape(-1).float()
        full = torch.empty(self._sizes[i], dtype=p.dtype, device=p.device)
        self._gather_into(full, p.detach().reshape(-1))
        return full.float()

    def _gather_into(self, out, shard):
        if self._group:
            torch.distributed.all_gather_into_tensor(out, shard.contiguous())
        else:
            out.copy_(shard)

    def _segments(self, flat, lo):
        """Views of ``flat`` (which starts at flat offset ``lo``): one piece
        of each parameter this rank's slice holds."""
        return [flat[a - lo:b - lo] for _, a, b in self._pieces] or [flat]

    def init(self, params, names=None):
        """Lay out ``params`` (the engine's trainable parameters, in order,
        fp32), build this rank's master and optimizer state, and rebind the
        parameters to the flat compute-dtype buffer (stage 3: to their
        shards)."""
        self.rank, self.world = group_rank_and_size()
        self._group = torch.distributed.is_available() and torch.distributed.is_initialized()
        self._params = list(params)
        self._names = list(names) if names is not None else [str(i) for i in
                                                            range(len(self._params))]
        self.device = self._params[0].device
        self._shapes = [tuple(getattr(p, "ds_shape", None) or p.shape) for p in self._params]
        self._sizes = [math.prod(s) for s in self._shapes]
        self._offsets, self._numel = flat_offsets(self._sizes, ALIGN)
        unit = self.world * ALIGN
        self._padded = max(unit, -(-self._numel // unit) * unit)
        self._shard = self._padded // self.world
        self._lo = self.rank * self._shard
        self._hi = self._lo + self._shard
        # (param index, flat lo, flat hi) of each parameter piece in the slice
        self._pieces = []
        for i, (off, n) in enumerate(zip(self._offsets, self._sizes)):
            a, b = max(off, self._lo), min(off + n, self._hi)
            if a < b:
                self._pieces.append((i, a, b))
        self._piece_names = [self._names[i] for i, _, _ in self._pieces]

        if getattr(self.inner, "no_decay_names", None) and self.cpu_offload:
            raise ValueError("no_decay_names is not supported with cpu_offload (the host "
                             "C++ Adam applies decay uniformly); drop one of the two")
        if self.stage >= 3:
            assert not self.cpu_offload, (
                "ZeRO-3 + cpu_offload is not supported: stage 3's win is sharded on-device "
                "param storage; combine offload with stage 2")
        if self.overlap_comm and self._group:
            self._buckets = compute_bucket_ranges(self._sizes, self.reduce_bucket_size)
        elif self._offload_streaming:
            total = sum(self._sizes)
            self._buckets = compute_bucket_ranges(
                self._sizes, max(1, -(-total // self.offload_stream_buckets)))
        if self._buckets is not None:
            self.bucket_numels = [sum(self._sizes[lo:hi]) for lo, hi in self._buckets]
            log_dist(f"ZeRO: {len(self._buckets)} bucket(s) "
                     f"({'offload stream' if self.cpu_offload else 'overlap_comm'}, "
                     f"numels={self.bucket_numels})", ranks=[0])

        dev, cdt = self.device, self.compute_dtype
        with torch.no_grad():
            if self.cpu_offload:
                self._init_offload()
            else:
                self._master = torch.zeros(self._shard, dtype=torch.float32, device=dev)
                pieces = {i: (a, b) for i, a, b in self._pieces}
                for i in range(len(self._params)):   # every rank, in order: may gather
                    full = self._full_fp32(i)
                    if i in pieces:
                        (a, b), off = pieces[i], self._offsets[i]
                        self._master[a - self._lo:b - self._lo].copy_(full[a - off:b - off])
                self._master_segs = self._segments(self._master, self._lo)
                self.inner_state = self.inner.init(self._master_segs)
            # the module's parameters
            if self.stage >= 3:
                self._eligible = zero3_param_shardings(self._shapes, self.world)
                self._storage = []
                for i, p in enumerate(self._params):
                    if self._eligible[i] and getattr(p, "ds_shape", None) is not None:
                        shard = p.detach().to(cdt).reshape(-1).clone()
                    elif self._eligible[i]:
                        n = self._sizes[i] // self.world
                        shard = p.detach().reshape(-1)[self.rank * n:(self.rank + 1) * n]
                        shard = shard.to(cdt).clone()
                    else:
                        shard = p.detach().to(cdt).reshape(-1).clone()
                    self._storage.append(shard)
                    p.ds_shape = self._shapes[i]
                self._full = None
                self._reshard()
            else:
                self._flat_param = torch.zeros(self._padded, dtype=cdt, device=dev)
                views = unflatten_dense_tensors(self._flat_param, self._shapes, ALIGN)
                for p, v in zip(self._params, views):
                    v.copy_(p.detach())
                    p.data = v
            # the engine's gradient accumulator
            self._acc_flat = torch.zeros(self._padded, dtype=torch.float32, device=dev)
            self.acc_grads = unflatten_dense_tensors(self._acc_flat, self._shapes, ALIGN)
        self._pending = []          # overlap_comm: the step's in-flight reduces
        self._hooked = False
        log_dist(f"ZeRO stage {self.stage}: {self._numel} elements "
                 f"(padded {self._padded}) over {self.world} rank(s), "
                 f"{self._shard} a rank{', master on host' if self.cpu_offload else ''}",
                 ranks=[0])

    # -- stage 3 ------------------------------------------------------------
    def _reshard(self):
        """Stage 3: every parameter back to its stored shard."""
        for i, p in enumerate(self._params):
            shape = ((self._shapes[i][0] // self.world,) + self._shapes[i][1:]
                     if self._eligible[i] else self._shapes[i])
            p.data = self._storage[i].view(shape)
        self._full = None

    def gather_params(self):
        """Stage 3: gather every parameter whole into one flat buffer before
        the step's first forward; they stay gathered through the backward
        (and its recompute) until the update re-shards them."""
        if self.stage < 3 or self._full is not None:
            return
        with torch.no_grad():
            full = torch.zeros(self._padded, dtype=self.compute_dtype, device=self.device)
            views = unflatten_dense_tensors(full, self._shapes, ALIGN)
            for i, (p, v) in enumerate(zip(self._params, views)):
                if self._eligible[i]:
                    self._gather_into(v.view(-1), self._storage[i])
                else:
                    v.view(-1).copy_(self._storage[i])
                p.data = v
            self._full = full

    # -- gradients ----------------------------------------------------------
    def register_overlap_hooks(self, factor):
        """overlap_comm: accumulate each gradient as it lands (times
        ``factor``) and all-reduce a bucket as soon as its last gradient is
        in. Returns True when the hooks took over the engine's
        accumulation."""
        self.hooks_paused = False
        if not (self.overlap_comm and self._group):
            return False
        self._landed = [0] * len(self._buckets)
        self._bucket_of = {}
        for b, (lo, hi) in enumerate(self._buckets):
            for i in range(lo, hi):
                self._bucket_of[i] = b

        def hook(i):
            def fn(p):
                if self.hooks_paused:
                    return          # a FLOPS count pass: its gradients are dropped
                with torch.no_grad():
                    self.acc_grads[i].add_(p.grad, alpha=factor)
                p.grad = None
                b = self._bucket_of[i]
                self._landed[b] += 1
                lo, hi = self._buckets[b]
                if self._landed[b] == hi - lo:
                    self._pending.append((b, torch.distributed.all_reduce(
                        self._bucket_span(b), async_op=True)))
            return fn

        for i, p in enumerate(self._params):
            p.register_post_accumulate_grad_hook(hook(i))
        self._hooked = True
        return True

    def _bucket_span(self, b):
        lo, hi = self._buckets[b]
        end = self._offsets[hi] if hi < len(self._offsets) else self._padded
        return self._acc_flat[self._offsets[lo]:end]

    def _all_reduce_mean(self, t):
        torch.distributed.all_reduce(t)
        if self.world > 1:
            t.div_(self.world)

    def reduce_gradients(self):
        """This rank's accumulated gradients, reduced over the world (their
        mean), as one view per piece of the master it steps (under offload:
        the whole vector, each rank stepping all of it as the JAX
        package's offload does)."""
        acc = self._acc_flat
        if self._hooked:
            done = {b for b, _ in self._pending}
            for _, work in self._pending:
                work.wait()
            for b in range(len(self._buckets)):
                if b not in done:    # a bucket with a parameter that got no gradient
                    torch.distributed.all_reduce(self._bucket_span(b))
            self._pending = []
            self._landed = [0] * len(self._buckets)
            if self.world > 1:
                acc.div_(self.world)
            return self._segments(acc[self._lo:self._hi], self._lo)
        if self.cpu_offload:
            if self._group:
                self._all_reduce_mean(acc)
            return unflatten_dense_tensors(acc, [(n,) for n in self._sizes], ALIGN)
        if not self._group:
            return self._segments(acc[self._lo:self._hi], self._lo)
        if self.stage >= 2 and self.reduce_scatter:
            if not hasattr(self, "_grad_shard"):
                self._grad_shard = torch.empty(self._shard, dtype=torch.float32,
                                               device=self.device)
            torch.distributed.reduce_scatter_tensor(self._grad_shard, acc)
            if self.world > 1:
                self._grad_shard.div_(self.world)
            return self._segments(self._grad_shard, self._lo)
        self._all_reduce_mean(acc)
        return self._segments(acc[self._lo:self._hi], self._lo)

    def zero_grad(self):
        self._acc_flat.zero_()

    def _sum_over_ranks(self, t):
        if self._group:
            torch.distributed.all_reduce(t)
        return t

    def has_overflow(self, grads):
        """A device bool: does any rank's gradient hold an inf or a nan?"""
        flag = has_overflow(grads)
        if not self._group or self.cpu_offload:
            return flag
        flag = flag.float()
        torch.distributed.all_reduce(flag, op=torch.distributed.ReduceOp.MAX)
        return flag > 0

    def global_norm(self, grads):
        """The L2 norm of the whole gradient: the squares summed over the
        ranks (the padding is zero)."""
        if not self._group or self.cpu_offload:
            return global_norm(grads)
        sq = torch.stack(torch._foreach_norm(grads)).square().sum()
        return self._sum_over_ranks(sq).sqrt()

    # -- device path --------------------------------------------------------
    def update(self, grads, lr=None):
        """Step this rank's slice of the master from ``grads`` (the views
        ``reduce_gradients`` returned, unscaled and clipped), then rebuild
        the module's parameters in the compute dtype: all-gather the slices
        (stage 3: and re-shard). Under ``cpu_offload``: ``update_host``."""
        if self.cpu_offload:
            return self.update_host(lr=lr)
        kwargs = {"sum_sq": self._sum_over_ranks} if self.name == "lamb" else {}
        with torch.no_grad():
            self.inner.update(grads, self.inner_state, self._master_segs, lr=lr,
                              names=self._piece_names, **kwargs)
            self._publish_params()

    def _publish_params(self):
        """The module's compute-dtype parameters from the master, with the
        step's own cast: all-gather the slices (stage 3: and re-shard);
        under offload, the host master cast and copied up."""
        if self.cpu_offload:
            _wait(self._h2d_done)
            self._flat_param[:self._numel].copy_(
                self._h2d_source(self._host_master, 0, self._numel))
            return
        if self.stage >= 3:
            self.gather_params()   # the full buffer, if no forward made it
            target = self._full
        else:
            target = self._flat_param
        if self._group:
            src = self._master.to(self.compute_dtype)
            torch.distributed.all_gather_into_tensor(target, src)
        else:
            target.copy_(self._master)
        if self.stage >= 3:
            for i in range(len(self._params)):
                if self._eligible[i]:
                    n = self._sizes[i] // self.world
                    off = self._offsets[i] + self.rank * n
                    self._storage[i].copy_(target[off:off + n])
                else:
                    off = self._offsets[i]
                    self._storage[i].copy_(target[off:off + self._sizes[i]])
            self._reshard()

    def master_params(self):
        """The whole fp32 master, one tensor per parameter (gathered from
        every rank's slice; under offload, from the host master)."""
        if self.cpu_offload:
            full = self._host_master
        elif self._group:
            full = torch.empty(self._padded, dtype=torch.float32, device=self.device)
            torch.distributed.all_gather_into_tensor(full, self._master)
        else:
            full = self._master
        return [t.clone() for t in unflatten_dense_tensors(full, self._shapes, ALIGN)]

    # -- checkpoint shards --------------------------------------------------
    def _state_slice(self, tensors):
        """This rank's ``[lo, hi)`` of the flat vector from one state
        tensor a piece (zeros in the alignment gaps)."""
        if len(self._pieces) == 0:
            return tensors[0]
        flat = torch.zeros(self._shard, dtype=torch.float32, device=self.device)
        for t, (_, a, b) in zip(tensors, self._pieces):
            flat[a - self._lo:b - self._lo].copy_(t)
        return flat

    def shard_state_dict(self):
        """This rank's checkpoint shard: its slice ``[lo, min(hi, numel))``
        of the flat master and of each flat optimizer state, unpadded, as
        compact CPU tensors. The master is omitted (``master_from_params``)
        under fp32 compute without offload, where the module's fp32 values
        are the master. Under offload the slices come from the host master
        and the host Adam's state, whose step is saved with them."""
        n = max(0, min(self._hi, self._numel) - self._lo)
        shard = {"rank": self.rank, "dp_world_size": self.world, "numel": self._numel,
                 "align": ALIGN, "cpu_offload": self.cpu_offload}
        if self.cpu_offload:
            hs = self._host_inner
            part = lambda t: _host_copy(t[self._lo:self._lo + n])
            shard.update(master_from_params=False, flat_master=part(self._host_master),
                         inner={"step": hs.step, "exp_avg": part(hs.exp_avg),
                                "exp_avg_sq": part(hs.exp_avg_sq)})
            return shard
        from_params = self.compute_dtype == torch.float32
        inner = {}
        for field in dataclasses.fields(self.inner_state):
            v = getattr(self.inner_state, field.name)
            inner[field.name] = _host_copy(self._state_slice(v)[:n]) if isinstance(v, list) \
                else v
        shard.update(master_from_params=from_params,
                     flat_master=None if from_params else _host_copy(self._master[:n]),
                     inner=inner)
        return shard

    def _merge(self, shards, key, field=None):
        """The whole padded flat vector of ``key`` (or of the optimizer
        state ``field``) from every saved rank's slice."""
        parts = [s[key] if field is None else s[key][field] for s in shards]
        full = torch.zeros(self._padded, dtype=torch.float32)
        full[:self._numel].copy_(torch.cat([p.float() for p in parts])[:self._numel])
        return full

    def load_shard_state_dicts(self, shards):
        """Merge the shards of every rank of a save at any dp degree and
        copy this rank's part into the master and the optimizer state in
        place (the parameters' views, the gradient hooks' buckets and the
        offload's pinned buffers stay where they are); then the module's
        parameters are rebuilt from the master with the step's cast."""
        shards = sorted(shards, key=lambda s: s["rank"])
        ranks = [s["rank"] for s in shards]
        if ranks != list(range(shards[0]["dp_world_size"])):
            raise ValueError(f"zero shard files incomplete: have ranks {ranks}, "
                             f"expected 0..{shards[0]['dp_world_size'] - 1}")
        numel = shards[0]["numel"]
        assert numel == self._numel and shards[0]["align"] == ALIGN, (
            f"checkpoint numel {numel} != model numel {self._numel}")
        if not shards[0].get("master_from_params"):
            # otherwise the module file's fp32 values, loaded first, are it
            self._load_flat_master(self._merge(shards, "flat_master"))
        fields = list(shards[0]["inner"])
        with torch.no_grad():
            if self.cpu_offload:
                hs = self._host_inner
                hs.step = int(shards[0]["inner"]["step"])
                hs.exp_avg.copy_(self._merge(shards, "inner", "exp_avg"))
                hs.exp_avg_sq.copy_(self._merge(shards, "inner", "exp_avg_sq"))
                return
            for name in fields:
                cur = getattr(self.inner_state, name)
                if not isinstance(cur, list):
                    setattr(self.inner_state, name, type(cur)(shards[0]["inner"][name]))
                    continue
                mine = self._merge(shards, "inner", name)[self._lo:self._hi].to(self.device)
                torch._foreach_copy_(cur, self._segments(mine, self._lo))

    def _load_flat_master(self, full):
        """Copy the padded flat fp32 vector ``full`` (any device) into this
        rank's master in place and rebuild the module's parameters. The
        offload's ping-pong partner is dropped: it holds the abandoned
        timeline, and the next streamed step allocates a fresh one."""
        with torch.no_grad():
            if self.cpu_offload:
                self._host_master.copy_(full)
                self._offload_master_next = None
            else:
                self._master.copy_(full[self._lo:self._hi])
            self._publish_params()

    def load_master_params(self, values):
        """Set the whole master from one fp32 tensor a parameter, in the
        engine's order (the module file of a checkpoint)."""
        full = torch.zeros(self._padded, dtype=torch.float32)
        for v, off, n in zip(values, self._offsets, self._sizes):
            full[off:off + n].copy_(v.reshape(-1))
        self._load_flat_master(full)

    # -- host path (ZeRO-Offload) -------------------------------------------
    def _pinned(self, n, dtype):
        pin = self.device.type == "cuda"
        return torch.zeros(n, dtype=dtype, pin_memory=pin)

    def _init_offload(self):
        """The host master (the whole vector, as in the JAX package), the
        host Adam state, and the pinned staging buffers, each allocated
        once: the gradients' D2H buffer (the whole vector sequentially, two
        bucket slots streamed) and the compute-dtype H2D buffer."""
        if not hasattr(self.inner, "step_host"):
            raise TypeError(
                f"cpu_offload steps the optimizer on the host, and "
                f"{type(self.inner).__name__} has no host step (step_host): use Adam or "
                "AdamW with cpu_offload")
        fp32 = self.compute_dtype == torch.float32
        master = (self._pinned(self._padded, torch.float32) if fp32 else
                  torch.zeros(self._padded, dtype=torch.float32))
        for i in range(len(self._params)):
            off = self._offsets[i]
            master[off:off + self._sizes[i]].copy_(self._full_fp32(i))
        self._host_master = master
        self._host_inner = self.inner.init_host(master)
        # each bucket's span of the flat vector: its parameters and the
        # alignment gaps after them
        slot = self._numel
        if self._offload_streaming:
            ends = [self._offsets[lo] for lo, _ in self._buckets[1:]] + [self._numel]
            self._bucket_spans = list(zip([0] + ends[:-1], ends))
            slot = max(hi - lo for lo, hi in self._bucket_spans)
        self._grad_slots = [self._pinned(slot, torch.float32)
                            for _ in range(2 if self._offload_streaming else 1)]
        self._h2d_staging = None if fp32 else self._pinned(self._padded, self.compute_dtype)
        self._d2h = _Copies(self.device)
        self._h2d = _Copies(self.device)
        log_dist(f"ZeRO-Offload: {master.numel() * 4 / 1e6:.1f} MB master on host "
                 f"({'streamed, %d buckets' % len(self._buckets) if self._offload_streaming else 'sequential'}, "
                 f"pin_host={self.offload_pin_host})", ranks=[0])

    def _d2h_copy(self, lo, hi, slot):
        """Queue the D2H copy of gradient elements [lo, hi) into ``slot`` on
        the D2H stream; returns (start event, end event, host seconds)."""
        t0 = time.perf_counter()
        start = self._d2h.event()
        with allowed_transfer(OFFLOAD_D2H), self._d2h.context():
            slot[:hi - lo].copy_(self._acc_flat[lo:hi], non_blocking=True)
        return start, self._d2h.event(), time.perf_counter() - t0

    def _h2d_copy(self, lo, hi, src):
        """Queue the H2D copy of the updated parameters [lo, hi) from the
        host tensor ``src`` (of the compute dtype) on the H2D stream."""
        t0 = time.perf_counter()
        start = self._h2d.event()
        with allowed_transfer(OFFLOAD_H2D), self._h2d.context():
            self._flat_param[lo:hi].copy_(src, non_blocking=True)
        return start, self._h2d.event(), time.perf_counter() - t0

    def _h2d_source(self, master, lo, hi):
        """The compute-dtype host slice to copy up: the master itself in
        fp32, else the cast into the pinned staging buffer."""
        if self._h2d_staging is None:
            return master[lo:hi]
        staged = self._h2d_staging[lo:hi]
        staged.copy_(master[lo:hi])
        return staged

    def _begin_host_step(self):
        """The side streams wait for the backward (the gradients are
        final, the parameters no longer read), and the host waits for the
        previous step's H2D copies, so no buffer they read from is
        rewritten while they are in flight."""
        self._d2h.follow()
        self._h2d.follow()
        _wait(self._h2d_done)

    def _end_host_step(self, h2d_end):
        """The compute stream waits for both side streams (the next forward
        reads the new parameters, the accumulator is zeroed after its D2H
        read)."""
        self._h2d.lead()
        self._d2h.lead()
        self._h2d_done = h2d_end

    def update_host(self, lr=None):
        """The host step of ZeRO-Offload on the gradients left in the
        accumulator by ``reduce_gradients`` (unscaled and clipped).
        ``offload_stream_buckets`` >= 2 runs the three-stage pipeline; 1
        the sequential step. The two are bit for bit the same: stepping
        the host Adam over any disjoint cover of the vector equals one
        whole step."""
        with torch.no_grad():
            if self._offload_streaming:
                return self._update_host_streamed(lr)
            return self._update_host_sequential(lr)

    def _update_host_sequential(self, lr):
        """D2H of the whole gradient, the host Adam in place (in bf16 fused
        with the cast into the H2D staging buffer), H2D of the whole
        parameter vector, one after the other."""
        t_wall = time.perf_counter()
        tracer = telemetry.get_tracer()
        self._begin_host_step()
        n = self._numel
        with _span(tracer, "train/offload_d2h", 0, n):
            d2h = self._d2h_copy(0, n, self._grad_slots[0])
            _wait(d2h[1])
        t0 = time.perf_counter()
        master = self._host_master
        with _span(tracer, "train/offload_host_step", 0, n):
            if self.compute_dtype == torch.bfloat16:
                self.inner.step_host(master, self._grad_slots[0][:n], lr=lr, lo=0, hi=n,
                                     out_bf16=self._h2d_staging[:n])
                src = self._h2d_staging[:n]
            else:
                self.inner.step_host(master, self._grad_slots[0][:n], lr=lr, lo=0, hi=n)
                src = self._h2d_source(master, 0, n)
        host_s = time.perf_counter() - t0
        with _span(tracer, "train/offload_h2d", 0, n):
            h2d = self._h2d_copy(0, n, src)
            _wait(h2d[1])
        self._end_host_step(h2d[1])
        self._record_stats(1, _elapsed_ms(*d2h), host_s, _elapsed_ms(*h2d), t_wall)

    def _ensure_offload_pipeline(self):
        """The two persistent daemon workers of the streamed host step:
        'zero-offload-adam' (the host optimizer) and 'zero-offload-h2d' (the
        cast and H2D commit). Started at the first streamed step."""
        if self._offload_queues is not None and \
                all(t.is_alive() for t in self._offload_threads):
            return self._offload_queues
        adam_q, h2d_q = queue.Queue(), queue.Queue()
        threads = (threading.Thread(target=_offload_stage_loop, args=(adam_q,),
                                    name="zero-offload-adam", daemon=True),
                   threading.Thread(target=_offload_stage_loop, args=(h2d_q,),
                                    name="zero-offload-h2d", daemon=True))
        for t in threads:
            t.start()
        self._offload_queues = (adam_q, h2d_q)
        self._offload_threads = threads
        return self._offload_queues

    def close(self):
        """Stop the offload pipeline's workers (they are daemons, so an
        exiting interpreter does not wait for them either)."""
        if self._offload_queues is not None:
            for q in self._offload_queues:
                q.put(None)
            for t in self._offload_threads:
                t.join()
            self._offload_queues = self._offload_threads = None

    def _update_host_streamed(self, lr):
        """Three stages a bucket at a time:

          1. (training thread) the bucket's D2H on the D2H stream into one
             of two pinned gradient slots, after a two-slot semaphore lets
             it (at most two buckets of gradients in flight);
          2. ('zero-offload-adam') waits on that bucket's D2H event, not on
             the device, then the host Adam out of place from the master
             into its ping-pong partner, and frees the slot;
          3. ('zero-offload-h2d') casts the bucket into the pinned staging
             buffer (fp32: none) and queues its H2D on the H2D stream.

        The host Adam of bucket i overlaps the D2H of bucket i+1 and the H2D
        of bucket i-1. After the last bucket the partner becomes the master;
        under ``offload_pin_host`` the old master is kept as the next
        partner, otherwise a fresh one is allocated every step. No buffer
        an H2D reads from is rewritten before that copy has finished (the
        next step waits for it first). A worker's error is raised here,
        and the master is then left as it was."""
        t_wall = time.perf_counter()
        tracer = telemetry.get_tracer()
        self._begin_host_step()
        adam_q, h2d_q = self._ensure_offload_pipeline()
        src = self._host_master
        dst = self._offload_master_next
        if not (self.offload_pin_host and dst is not None):
            dst = (self._pinned(self._padded, torch.float32)
                   if self.compute_dtype == torch.float32 and self.offload_pin_host
                   else torch.empty_like(src))
        dst[self._numel:].copy_(src[self._numel:])   # the padding tail, zeros
        state = {"error": None, "host_s": 0.0, "h2d_ms": 0.0, "h2d_end": None}
        slot_free = threading.Semaphore(2)
        done = threading.Event()

        def h2d_task(b, lo, hi):
            try:
                if state["error"] is None:
                    with _span(tracer, "train/offload_h2d", b, hi - lo):
                        start, end, host_s = self._h2d_copy(lo, hi,
                                                            self._h2d_source(dst, lo, hi))
                        _wait(end)
                    state["h2d_ms"] += _elapsed_ms(start, end, host_s)
                    state["h2d_end"] = end
            except BaseException as e:  # noqa: BLE001 -- raised on the training thread
                state["error"] = e

        def adam_task(b, lo, hi, d2h):
            t0 = time.perf_counter()
            try:
                if state["error"] is None:
                    with _span(tracer, "train/offload_host_step", b, hi - lo):
                        _wait(d2h[1])
                        self.inner.step_host(src, self._grad_slots[b % 2][:hi - lo], lr=lr,
                                             lo=lo, hi=hi, advance_step=b == 0,
                                             master_out=dst)
            except BaseException as e:  # noqa: BLE001 -- raised on the training thread
                state["error"] = e
            finally:
                state["host_s"] += time.perf_counter() - t0
                slot_free.release()
            h2d_q.put(lambda: h2d_task(b, lo, hi))

        d2h_ms = 0.0
        d2h_events = []
        for b, (lo, hi) in enumerate(self._bucket_spans):
            slot_free.acquire()
            if state["error"] is not None:
                slot_free.release()
                break
            with _span(tracer, "train/offload_d2h", b, hi - lo):
                d2h = self._d2h_copy(lo, hi, self._grad_slots[b % 2])
            d2h_events.append(d2h)
            adam_q.put(lambda b=b, lo=lo, hi=hi, d2h=d2h: adam_task(b, lo, hi, d2h))
        # FIFO queues with one worker each: this runs after every bucket's
        # host step, which queued every bucket's H2D first
        adam_q.put(lambda: h2d_q.put(done.set))
        done.wait()
        for d2h in d2h_events:
            d2h_ms += _elapsed_ms(*d2h)
        self._end_host_step(state["h2d_end"])
        if state["error"] is not None:
            raise state["error"]
        self._host_master = dst
        self._offload_master_next = src if self.offload_pin_host else None
        self._record_stats(len(self._bucket_spans), d2h_ms, state["host_s"],
                           state["h2d_ms"], t_wall)

    def _record_stats(self, buckets, d2h_ms, host_s, h2d_ms, t_wall):
        """``last_offload_stats`` of the step: each stage's summed time (the
        copies' device time on the card), the wall time, and the share of
        the summed stage time hidden by running the stages together."""
        wall_ms = (time.perf_counter() - t_wall) * 1e3
        busy = d2h_ms + host_s * 1e3 + h2d_ms
        overlap = max(0.0, min(1.0, (busy - wall_ms) / busy)) if busy > 0 else 0.0
        self.last_offload_stats = {"buckets": buckets, "d2h_ms": d2h_ms,
                                   "host_step_ms": host_s * 1e3, "h2d_ms": h2d_ms,
                                   "wall_ms": wall_ms, "overlap_frac": overlap}
