"""ZeRO stages 1 and 2 under tensor parallelism: per-parameter shards.

Port of ``deepspeed_tpu/runtime/zero/pytree_optimizer.py``. The flat ZeRO
optimizer (``sharded_optimizer.py``) concatenates every parameter into one
vector, which would mix the model-axis shards of tensor parallelism; this
one keeps the parameters apart and splits each one's fp32 master and
optimizer state over the data group on its own dimension, as JAX's does
with a ``data`` axis added to the parameter's TP spec:

- the dimension is the largest free dimension of the parameter's local
  shard that the data group divides, ordered in the flax layout as JAX's
  ``_master_spec`` orders it (an ``nn.Linear`` weight is a flax kernel
  [in, out]); a parameter with no such dimension keeps a whole master on
  every data rank;
- the accumulated gradient is reduce-scattered on that dimension (stage
  2; stage 1 all-reduces and keeps its part), the inner optimizer steps
  the shard, and the updated shard is all-gathered into the module's
  compute-dtype parameter;
- the gradient norm sums each part once: data-split shards over the data
  group, model-axis shards over the model group; the fp16 overflow flag
  is a MAX over both;
- ``cpu_offload``: this rank's master shards live on the host as one flat
  fp32 vector stepped by the host Adam (``DeepSpeedCPUAdam.step_host``),
  ``offload_stream_buckets`` slices at a time.

A checkpoint holds whole tensors (``whole_master`` / ``whole_state``,
gathered over both groups), so a tag loads at any data or model size and
``zero_to_fp32`` reads it.
"""

import torch

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.ops.utils_op import flatten_dense_tensors, unflatten_dense_tensors
from deepspeed_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS
from deepspeed_tpu_torch.parallel.tp import local_part, whole_of
from deepspeed_tpu_torch.profiling.sentinels import device_get, device_put
from deepspeed_tpu_torch.runtime.zero.sharded_optimizer import OFFLOAD_D2H, OFFLOAD_H2D
from deepspeed_tpu_torch.utils.logging import log_dist


def master_dim(shape, tp_dim, dp, flips=False):
    """The torch dim of a parameter (local shape ``shape``) that carries
    the data axis, or None: JAX's ``_master_spec`` on the flax layout
    (``flips``: an ``nn.Linear`` weight, reversed)."""
    n = len(shape)
    fl = (lambda i: n - 1 - i) if flips else (lambda i: i)
    fshape = [shape[fl(i)] for i in range(n)]
    taken = None if tp_dim is None else fl(tp_dim)
    for i in sorted(range(n), key=lambda i: -fshape[i]):
        if i != taken and fshape[i] % dp == 0 and fshape[i] >= dp:
            return fl(i)
    return None


def _list_fields(state, n):
    """Names of the state's fields that hold one tensor a parameter."""
    return [k for k, v in vars(state).items()
            if isinstance(v, list) and len(v) == n and all(torch.is_tensor(t) for t in v)]


class ZeroPytreeOptimizer:
    """ZeRO-1/2 over separate parameters; composes with TP shards."""

    def __init__(self, inner, stage=2, mesh=None, cpu_offload=False, offload_stream_buckets=1,
                 offload_pin_host=True):
        assert mesh is not None
        self.inner = inner
        self.stage = stage
        self.mesh = mesh
        self.dp = mesh.shape[DATA_AXIS]
        self.dp_rank = mesh.rank(DATA_AXIS)
        self.dp_group = mesh.group(DATA_AXIS)
        self.mp_group = mesh.group(MODEL_AXIS)
        self.cpu_offload = bool(cpu_offload)
        self.offload_stream_buckets = max(1, int(offload_stream_buckets))
        self.offload_pin_host = bool(offload_pin_host)
        self.state = None

    def init(self, params, names, masters, tp_place, flips):
        """``params``: the module's parameters (local TP shards);
        ``masters``: their fp32 values; ``tp_place``: {name: (dim,
        sections)} of the model-axis shards; ``flips``: {name: bool}."""
        self.params, self.names = params, names
        self.tp = [tp_place.get(n) for n in names]
        self.dims = [master_dim(tuple(p.shape), None if t is None else t[0], self.dp,
                                flips.get(n, False))
                     for p, n, t in zip(params, names, self.tp)]
        self.master = [m.detach().float().clone() if d is None else
                       local_part(m.detach().float(), d, self.dp_rank, self.dp)
                       for m, d in zip(masters, self.dims)]
        self.acc_grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                          for p in params]
        if self.cpu_offload:
            self._host_master = flatten_dense_tensors(self.master).cpu()
            if self.offload_pin_host and torch.cuda.is_available():
                self._host_master = self._host_master.pin_memory()
            self.inner.init_host(self._host_master)
        split = sum(m.numel() for m, d in zip(self.master, self.dims) if d is not None)
        log_dist(f"ZeRO(pytree) stage {self.stage}: {split * 4 / 1e6:.1f} MB of fp32 master "
                 f"split over dp={self.dp}, {len(self.master)} tensors", ranks=[0])

    # -- the engine's step -------------------------------------------------
    def reduce_gradients(self):
        """Each parameter's mean gradient over the data group, as the part
        this rank steps."""
        out = []
        for acc, d in zip(self.acc_grads, self.dims):
            if d is None or self.dp == 1:
                g = comm.all_reduce(acc, self.dp_group) if self.dp > 1 else acc
            elif self.stage >= 2:
                g = comm.reduce_scatter(acc, self.dp_group, scatter_dimension=d)
            else:
                g = local_part(comm.all_reduce(acc, self.dp_group), d, self.dp_rank, self.dp)
            out.append(g / self.dp if self.dp > 1 else g)
        return out

    def has_overflow(self, grads):
        flag = torch.stack([(~torch.isfinite(g)).any() for g in grads]).any().float()
        for group in (self.dp_group, self.mp_group):
            flag = comm.all_reduce(flag, group, comm.ReduceOp.MAX)
        return flag > 0

    def global_norm(self, grads):
        """sqrt of the sum of squares of the whole gradient: each part
        counted once (data-split parts summed over the data group,
        model-axis shards over the model group)."""
        dev = grads[0].device
        parts = torch.zeros(2, 2, device=dev)   # [model-split][data-split]
        for g, d, t in zip(grads, self.dims, self.tp):
            parts[int(t is not None), int(d is not None)] += g.float().pow(2).sum()
        data_split = comm.all_reduce(parts[:, 1].contiguous(), self.dp_group)
        model_split = comm.all_reduce(torch.stack([data_split[1], parts[1, 0]]),
                                      self.mp_group)
        total = data_split[0] + parts[0, 0] + model_split.sum()
        return torch.sqrt(total)

    def update(self, grads, lr=None):
        with torch.no_grad():
            if self.cpu_offload:
                self._update_host(grads, lr)
            else:
                self.ensure_state()
                self.inner.update(grads, self.state, self.master, lr=lr, names=self.names)
            for p, m, d in zip(self.params, self.master, self.dims):
                full = m if d is None else comm.all_gather(m, self.dp_group, axis=d)
                p.data.copy_(full.to(p.dtype))

    def _update_host(self, grads, lr):
        """The host step under TP: the rank's gradients down and its
        masters up through the offload's two named transfer windows (the
        sanctioned pinned copies, which a transfer guard lets through)."""
        flat = device_get(flatten_dense_tensors([g.float() for g in grads]), OFFLOAD_D2H)
        n = flat.shape[0]
        k = self.offload_stream_buckets
        for b in range(k):
            lo, hi = b * n // k, (b + 1) * n // k
            self.inner.step_host(self._host_master, flat, lr=lr, lo=lo, hi=hi,
                                 advance_step=(b == 0))
        dev = self.master[0].device
        values = unflatten_dense_tensors(device_put(self._host_master, dev, OFFLOAD_H2D),
                                         [tuple(m.shape) for m in self.master])
        torch._foreach_copy_(self.master, values)

    def zero_grad(self):
        with torch.no_grad():
            torch._foreach_zero_(self.acc_grads)

    def ensure_state(self):
        if self.state is None:
            self.state = self.inner.init(self.master)
        return self.state

    # -- whole tensors (checkpoints, master_params) ------------------------
    def _whole(self, t, i):
        if self.dims[i] is not None:
            t = comm.all_gather(t, self.dp_group, axis=self.dims[i])
        if self.tp[i] is not None:
            t = whole_of(t, self.tp[i][0], self.mp_group, self.tp[i][1])
        return t

    def _part(self, t, i):
        if self.tp[i] is not None:
            t = local_part(t, self.tp[i][0], self.mesh.rank(MODEL_AXIS),
                           self.mesh.shape[MODEL_AXIS], self.tp[i][1])
        if self.dims[i] is not None:
            t = local_part(t, self.dims[i], self.dp_rank, self.dp)
        return t

    def master_params(self):
        """The whole fp32 masters (a collective of every rank)."""
        return [self._whole(m, i) for i, m in enumerate(self.master)]

    def load_master_params(self, values):
        """Whole fp32 values into this rank's master parts and the
        module's parameters."""
        with torch.no_grad():
            for i, (m, v) in enumerate(zip(self.master, values)):
                m.copy_(self._part(v.to(m.device).float(), i))
            if self.cpu_offload:
                self._host_master.copy_(flatten_dense_tensors(self.master).cpu())
            for p, m, d in zip(self.params, self.master, self.dims):
                full = m if d is None else comm.all_gather(m, self.dp_group, axis=d)
                p.data.copy_(full.to(p.dtype))

    def whole_state(self):
        """The optimizer state with whole tensors, as stage 0 saves it."""
        if self.cpu_offload:
            hs = self.inner._host_state
            shapes = [tuple(m.shape) for m in self.master]
            lists = {k: unflatten_dense_tensors(getattr(hs, k)[:sum(m.numel() for m in
                                                                     self.master)], shapes)
                     for k in ("exp_avg", "exp_avg_sq")}
            out = {"step": hs.step}
        else:
            state = self.ensure_state()
            lists = {k: getattr(state, k) for k in _list_fields(state, len(self.master))}
            out = {k: v for k, v in vars(state).items() if k not in lists}
        for k, ts in lists.items():
            out[k] = [self._whole(t.to(self.master[0].device), i) for i, t in enumerate(ts)]
        return out

    def load_whole_state(self, saved):
        """The state from a whole-tensor dict (``whole_state``, or a stage
        0 tag's optimizer state)."""
        with torch.no_grad():
            if self.cpu_offload:
                hs = self.inner._host_state
                hs.step = int(saved["step"])
                for k in ("exp_avg", "exp_avg_sq"):
                    flat = flatten_dense_tensors([self._part(t.float(), i)
                                                  for i, t in enumerate(saved[k])])
                    getattr(hs, k)[:flat.numel()].copy_(flat)
                return
            state = self.ensure_state()
            for k, v in saved.items():
                cur = getattr(state, k)
                if isinstance(cur, list):
                    torch._foreach_copy_(cur, [self._part(t.to(c.device), i)
                                               for i, (c, t) in enumerate(zip(cur, v))])
                else:
                    setattr(state, k, type(cur)(v))
