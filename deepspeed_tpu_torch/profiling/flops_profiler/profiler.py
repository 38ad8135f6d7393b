"""FLOPS profiler.

Port of ``deepspeed_tpu/profiling/flops_profiler/profiler.py``: per-step
model FLOPs/MACs/params and latency, the duration/FLOPS getters, the
per-module profile and the aggregated top-k view, with the same report
lines.

What is counted differs from the JAX package, which takes its totals from
XLA's cost model (``analyze``) and counts an elementwise operation as its
output size (``_eqn_flops``); neither has a PyTorch counterpart. Here the
step runs under ``torch.utils.flop_counter.FlopCounterMode``, which counts
matrix products (``mm``, ``addmm``, ``bmm``, convolutions, SDPA) at
2·M·N·K and nothing elementwise, and attributes each count to the
``nn.Module`` path it ran under; the per-module table is built from that
path (``Bert.encoder.layers.0`` -> ``Bert/encoder/layers_0``) as the
JAX package builds it from flax scopes. The hand-written CUDA kernels are
``ctypes`` launches the counter cannot see, so each wrapper reports its
FLOPs when it launches under a counting mode (``kernels/registry.py:
note_flops``): the count of the kernel's plain version on the same inputs,
recompute included, so a step counts the same on the card, where the
kernels run, as on the CPU, where the plain versions run.
"""

import re
import time

import torch
from torch.utils.flop_counter import FlopCounterMode

# the kernels' FLOP note is registered at import, before any counting mode
from deepspeed_tpu_torch.kernels import registry as _kernel_registry  # noqa: F401
from deepspeed_tpu_torch.utils.logging import logger

# Dense bf16 peak TFLOP/s by device-name substring (NVIDIA's spec): the
# denominator of the exported Train/Samples/mfu gauge.
_PEAK_TFLOPS = [
    ("h100 80gb hbm3", 989.0),   # H100 SXM5
    ("h100 sxm", 989.0),
]


def device_peak_tflops(device_name=None):
    """Dense bf16 peak TFLOP/s of a ``torch.cuda.get_device_name()`` string
    (the current card's when None), or None on the CPU and for an unknown
    card (MFU is then unreportable)."""
    if device_name is None:
        if not torch.cuda.is_available():
            return None
        device_name = torch.cuda.get_device_name()
    kind = (device_name or "").lower()
    for sub, peak in _PEAK_TFLOPS:
        if sub in kind:
            return peak
    return None


def _count_params(model):
    return sum(p.numel() for p in model.parameters())


def _scope(name, modules=()):
    """A FlopCounterMode module name as a scope path: dots become slashes,
    and the index of a list that never runs as a module of its own joins
    the list's name (``layers.0`` -> ``layers_0``, as flax names it)."""
    parts = name.split(".")
    out = []
    for i, part in enumerate(parts):
        if part.isdigit() and out and ".".join(parts[:i]) not in modules:
            out[-1] = f"{out[-1]}_{part}"
        else:
            out.append(part)
    return "/".join(out)


def _exclusive_flops(counts):
    """FlopCounterMode's inclusive per-module counts -> the FLOPs of the
    operations that ran directly in each scope ("" for those outside any
    module), which sum to the total."""
    inc = {name: sum(ops.values()) for name, ops in counts.items() if name != "Global"}
    exact = dict(inc)
    for name, f in inc.items():
        parent = name
        while "." in parent:
            parent = parent.rsplit(".", 1)[0]
            if parent in inc:
                exact[parent] -= f
                break
    total = sum(counts.get("Global", {}).values())
    out = {_scope(n, inc): f for n, f in exact.items() if f}
    outside = total - sum(f for n, f in inc.items() if "." not in n)
    if outside:
        out[""] = outside
    return out


def _params_by_scope(model, root):
    """Parameter counts keyed by the scope of the module that owns them."""
    acc = {}
    for name, p in model.named_parameters():
        owner = name.rsplit(".", 1)[0] if "." in name else ""
        scope = "/".join(x for x in (root, _scope(owner) if owner else "") if x)
        acc[scope] = acc.get(scope, 0) + p.numel()
    return acc


class FlopsProfiler:
    """Profile a step (or an engine's microbatch).

    Usage as in the JAX package: ``start_profile()`` / ``stop_profile()``
    bracket a step; getters expose flops/macs/params/duration;
    ``print_model_profile()`` emits the report. ``analyze`` and
    ``count_step`` run a callable under the counting mode."""

    def __init__(self, model=None, example_args=None):
        self.model = model
        self.example_args = example_args
        self.started = False
        self.flops = 0
        self.params = 0
        self.t_start = None
        self.duration = 0.0
        self.module_flops = {}   # exact scope -> flops of ops at that scope
        self.module_params = {}  # exact scope -> params owned by that scope

    # -- counting ------------------------------------------------------------
    def analyze(self, fn, *args):
        """FLOPs of one call of ``fn(*args)`` (matrix products and the
        kernels' reported counts)."""
        with FlopCounterMode(display=False) as mode:
            fn(*args)
        return int(mode.get_total_flops())

    def analyze_modules(self, fn, *args, params=None):
        """Per-module attribution of one ``fn(*args)`` call; ``params`` (an
        ``nn.Module``) additionally maps its parameter counts onto the
        same scopes."""
        with FlopCounterMode(display=False) as mode:
            fn(*args)
        self._set_modules(mode.get_flop_counts(), params)
        return self.module_flops

    def count_step(self, forward, backward=None, params=None):
        """One counting pass over a training microbatch: ``forward()``
        returns what ``backward(out)`` backpropagates. The per-module table
        is the forward's; the total is forward plus backward. Returns the
        total."""
        with FlopCounterMode(display=False) as mode:
            out = forward()
            fwd_counts = mode.get_flop_counts()
            if backward is not None:
                backward(out)
        self._set_modules(fwd_counts, params)
        self.set_flops(mode.get_total_flops())
        return self.flops

    def _set_modules(self, counts, params):
        self.module_flops = _exclusive_flops(counts)
        if params is not None:
            self.module_params = _params_by_scope(params, type(params).__name__)
        else:
            self.module_params = {}

    # -- step profiling (start/stop/print cycle) -----------------------------
    def start_profile(self, ignore_list=None):
        self.started = True
        self.t_start = time.perf_counter()

    def stop_profile(self):
        if self.t_start is not None:
            self.duration = time.perf_counter() - self.t_start
        self.started = False

    def reset_profile(self):
        self.flops = 0
        self.duration = 0.0
        self.t_start = None
        self.module_flops = {}
        self.module_params = {}

    def end_profile(self):
        self.reset_profile()

    def get_total_flops(self, as_string=False):
        return flops_to_string(self.flops) if as_string else self.flops

    def get_total_macs(self, as_string=False):
        macs = self.flops // 2
        return macs_to_string(macs) if as_string else macs

    def get_total_duration(self, as_string=False):
        return duration_to_string(self.duration) if as_string else self.duration

    def get_total_params(self, as_string=False):
        return params_to_string(self.params) if as_string else self.params

    def set_flops(self, flops):
        self.flops = int(flops)

    def set_params(self, model):
        self.params = _count_params(model)

    def achieved_tflops(self):
        """Model TFLOP/s of the profiled step (flops / wall duration), or
        None before a profile completes."""
        if not self.flops or self.duration <= 0:
            return None
        return self.flops / self.duration / 1e12

    def mfu(self, device_name=None):
        """Model FLOPs utilization against the card's dense bf16 peak, or
        None when the peak is unknown (CPU, an unrecognized card)."""
        achieved = self.achieved_tflops()
        if achieved is None:
            return None
        peak = device_peak_tflops(device_name)
        return achieved / peak if peak else None

    def _inclusive_tree(self):
        """Inclusive per-scope totals: every scope accumulates its subtree."""
        inc_f, inc_p = {}, {}
        for acc, inc in ((self.module_flops, inc_f), (self.module_params, inc_p)):
            for scope, v in acc.items():
                parts = [p for p in scope.split("/") if p]
                for d in range(1, len(parts) + 1):
                    key = "/".join(parts[:d])
                    inc[key] = inc.get(key, 0) + v
        return inc_f, inc_p

    def print_model_profile(self, profile_step=None, module_depth=-1, top_modules=3,
                            detailed=True, output_file=None):
        lines = [
            "-------------------------- DeepSpeed Flops Profiler --------------------------",
            f"Profile step:                   {profile_step}",
            f"Params:                         {self.get_total_params(as_string=True)}",
            f"FLOPs per step:                 {self.get_total_flops(as_string=True)}",
            f"MACs per step:                  {self.get_total_macs(as_string=True)}",
            f"Step latency:                   {self.get_total_duration(as_string=True)}",
        ]
        if self.duration > 0 and self.flops:
            lines.append(f"Achieved FLOPS:                 {flops_to_string(self.flops / self.duration)}/s")

        inc_f, inc_p = self._inclusive_tree()
        if inc_f:
            total_f = max(sum(self.module_flops.values()), 1)
            total_p = max(sum(self.module_params.values()), 1) if self.module_params else None
            lines += self._aggregated_lines(inc_f, inc_p, module_depth, top_modules)
            if detailed:
                # latency is modeled as the MACs share of the measured step,
                # as in the JAX package: the card overlaps the modules' work
                lines.append("")
                lines.append("per-module profile (latency modeled as MACs share of the step):")
                for scope in sorted(inc_f):
                    parts = scope.split("/")
                    f = inc_f[scope]
                    items = [
                        macs_to_string(f // 2),
                        f"{f / total_f:.2%} MACs",
                    ]
                    if total_p is not None:
                        p = inc_p.get(scope, 0)
                        items = [params_to_string(p), f"{p / total_p:.2%} Params"] + items
                    if self.duration > 0:
                        items.append(duration_to_string(self.duration * f / total_f))
                    lines.append("  " * len(parts) + f"{parts[-1]}: " + ", ".join(items))
                unattr = self.module_flops.get("", 0)
                if unattr:
                    # operations outside any module (the loss), printed so
                    # the per-module shares visibly sum to 100%
                    lines.append(
                        f"  (outside modules): {macs_to_string(unattr // 2)}, "
                        f"{unattr / total_f:.2%} MACs"
                    )
        lines.append("-" * 79)
        report = "\n".join(lines)
        if output_file:
            with open(output_file, "w") as f:
                f.write(report)
        else:
            logger.info("\n" + report)
        return report

    def _aggregated_lines(self, inc_f, inc_p, module_depth, top_modules):
        """Top-k module classes by MACs/params at a given depth (depth -1 =
        the innermost level); a trailing list index is stripped to
        aggregate by class."""
        by_depth = {}
        for scope, f in inc_f.items():
            parts = scope.split("/")
            d = len(parts) - 1
            cls = re.sub(r"_\d+$", "", parts[-1])
            ent = by_depth.setdefault(d, {}).setdefault(cls, [0, 0])
            ent[0] += f
            ent[1] += (inc_p or {}).get(scope, 0)
        if not by_depth:
            return []
        depth = module_depth if module_depth >= 0 else max(by_depth)
        depth = min(depth, max(by_depth))
        info = by_depth.get(depth, {})
        k = min(top_modules, len(info))
        top_macs = {c: macs_to_string(v[0] // 2) for c, v in
                    sorted(info.items(), key=lambda kv: kv[1][0], reverse=True)[:k]}
        lines = [f"Top {k} modules in MACs at depth {depth}: {top_macs}"]
        if inc_p:
            top_params = {c: params_to_string(v[1]) for c, v in
                          sorted(info.items(), key=lambda kv: kv[1][1], reverse=True)[:k]}
            lines.append(f"Top {k} modules in params at depth {depth}: {top_params}")
        return lines

    def print_aggregated_profile(self, module_depth=-1, top_modules=3):
        # the aggregate-only view
        self.print_model_profile(module_depth=module_depth, top_modules=top_modules,
                                 detailed=False)


def get_model_profile(model, args=(), kwargs=None, print_profile=True, detailed=True,
                      module_depth=-1, top_modules=3, warm_up=1, as_string=True,
                      output_file=None, ignore_modules=None):
    """One-shot: (flops, macs, params) of one forward call of ``model``
    (an ``nn.Module`` or any callable, such as a serving decode step) on
    ``args``, without grad. The parameters are the model's, or those of an
    ``nn.Module`` first argument."""
    kwargs = kwargs or {}
    prof = FlopsProfiler(model)
    params = model if isinstance(model, torch.nn.Module) else (
        args[0] if args and isinstance(args[0], torch.nn.Module) else None)
    with torch.no_grad():
        prof.analyze_modules(lambda *a: model(*a, **kwargs), *args, params=params)
    prof.set_flops(sum(prof.module_flops.values()))
    if params is not None:
        prof.set_params(params)
    if print_profile:
        prof.print_model_profile(output_file=output_file, detailed=detailed,
                                 module_depth=module_depth, top_modules=top_modules)
    flops = prof.flops
    macs = flops // 2
    if as_string:
        return flops_to_string(flops), macs_to_string(macs), params_to_string(prof.params)
    return flops, macs, prof.params


# -- formatting helpers (the JAX package exposes the same names) -------------

def _si(value, units, scale=1000.0, precision=2):
    for u in units:
        if abs(value) < scale:
            return f"{value:.{precision}f} {u}"
        value /= scale
    return f"{value:.{precision}f} {units[-1]}" if units else str(value)


def flops_to_string(flops, units=None, precision=2):
    return _si(float(flops), ["FLOPS", "KFLOPS", "MFLOPS", "GFLOPS", "TFLOPS", "PFLOPS"], precision=precision)


def macs_to_string(macs, units=None, precision=2):
    return _si(float(macs), ["MACs", "KMACs", "MMACs", "GMACs", "TMACs"], precision=precision)


def params_to_string(params_num, units=None, precision=2):
    return _si(float(params_num), ["", "k", "M", "G"], precision=precision).strip()


def duration_to_string(duration, units=None, precision=2):
    if duration > 1:
        return f"{duration:.{precision}f} s"
    if duration > 1e-3:
        return f"{duration * 1e3:.{precision}f} ms"
    return f"{duration * 1e6:.{precision}f} us"
