"""The port's kernel registry: names, backends and launch counts.

The JAX registry probes each Pallas kernel at first use and degrades to
the composed-XLA fallback when the probe fails. The port has no such
machinery: a wrapper given a CUDA tensor launches its hand-written
kernel or raises, and a wrapper given a CPU tensor runs the kernel's
plain PyTorch version. What stays is the bookkeeping: which kernel sits
behind which ``attention_impl`` backend, and a plain per-kernel count of
launches that each wrapper bumps where it launches its kernel (and
nowhere else), so a run can show that its main path went through the
kernels. The host kernels (``csrc/cpu_adam.cpp``, the Adam of
ZeRO-Offload, and the four host ops of ``csrc/host_ops.cpp``, built with
``g++``) are counted apart from the CUDA kernels (``host_launch_counts``).

Under a counting mode (the FLOPS profiler's ``FlopCounterMode``) each CUDA
wrapper also reports its kernel's FLOPs (``note_flops``), which the
counter cannot see in a ``ctypes`` launch: the count its plain version
gives on the same inputs.
"""

import torch
from torch.utils import flop_counter
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
from torch.utils.flop_counter import register_flop_formula

KERNEL_NAMES = ("decode_attention", "sparse_attention", "flash_attention_fwd",
                "flash_attention_bwd_dq", "flash_attention_bwd_dkv")

# attention_impl backend name -> the kernel behind it
KERNEL_BACKENDS = {"pallas_decode": "decode_attention",
                   "pallas_sparse": "sparse_attention"}

# where each kernel lives in this package, and the TPU kernel it replaces
KERNEL_SOURCES = {
    "decode_attention": ("deepspeed_tpu_torch/csrc/decode_attention.cu",
                         "deepspeed_tpu/kernels/decode_attention.py:89"),
    "sparse_attention": ("deepspeed_tpu_torch/csrc/band_attention.cu",
                         "deepspeed_tpu/kernels/sparse_attention.py:68"),
    "flash_attention_fwd": ("deepspeed_tpu_torch/csrc/flash_attention.cu",
                            "deepspeed_tpu/ops/transformer/attention.py:94"),
    "flash_attention_bwd_dq": ("deepspeed_tpu_torch/csrc/flash_attention.cu",
                               "deepspeed_tpu/ops/transformer/attention.py:204"),
    "flash_attention_bwd_dkv": ("deepspeed_tpu_torch/csrc/flash_attention.cu",
                                "deepspeed_tpu/ops/transformer/attention.py:246"),
}

# the host kernels, their sources, and the JAX package's host kernels they port
HOST_KERNEL_NAMES = ("cpu_adam", "host_flatten", "host_unflatten", "host_layout_to_lut",
                     "host_lamb_step")
HOST_KERNEL_SOURCES = {
    "cpu_adam": ("deepspeed_tpu_torch/csrc/cpu_adam.cpp", "csrc/cpu_adam.cpp:15"),
    "host_flatten": ("deepspeed_tpu_torch/csrc/host_ops.cpp", "csrc/host_ops.cpp:26"),
    "host_unflatten": ("deepspeed_tpu_torch/csrc/host_ops.cpp", "csrc/host_ops.cpp:40"),
    "host_layout_to_lut": ("deepspeed_tpu_torch/csrc/host_ops.cpp", "csrc/host_ops.cpp:56"),
    "host_lamb_step": ("deepspeed_tpu_torch/csrc/host_ops.cpp", "csrc/host_ops.cpp:75"),
}

_launches = dict.fromkeys(KERNEL_NAMES, 0)
_host_launches = dict.fromkeys(HOST_KERNEL_NAMES, 0)


def kernel_for_backend(attn_impl):
    """Kernel name behind an ``attention_impl`` backend, or None for
    backends that run no kernel."""
    return KERNEL_BACKENDS.get(attn_impl)


def record_launch(name):
    """Count one launch of ``name`` (called by its wrapper right after
    the launch)."""
    counts = _host_launches if name in _host_launches else _launches
    counts[name] += 1


@torch.library.custom_op("dstorch::kernel_flops", mutates_args=())
def _kernel_flops(anchor: torch.Tensor, kernel: str, flops: int) -> None:
    """A no-op whose FLOP formula is the count it is handed. Registered at
    import: a ``FlopCounterMode`` copies the formulas when it is made, so
    one made before the registration would count nothing here."""
    return None


@register_flop_formula(torch.ops.dstorch.kernel_flops)
def _kernel_flops_formula(anchor_shape, kernel, flops, *args, **kwargs):
    return flops


# the mode a FlopCounterMode pushes on the dispatch stack (the counter
# itself in older releases, a private mode it owns in newer ones)
_COUNTING_MODES = (flop_counter.FlopCounterMode,
                   getattr(flop_counter, "_FlopCounterMode", flop_counter.FlopCounterMode))


def counting_flops():
    """True under a ``FlopCounterMode`` alone: only then does a wrapper
    report its kernel's FLOPs. Other dispatch modes (selective
    checkpointing's, around every layer of a checkpointed step) do not
    count."""
    return (torch._C._len_torch_dispatch_stack() > 0
            and any(isinstance(m, _COUNTING_MODES) for m in _get_current_dispatch_mode_stack()))


def note_flops(name, anchor, flops):
    """Report ``flops`` of kernel ``name`` (launched on ``anchor``'s card) to
    the counting mode, attributed to the modules the launch ran under."""
    torch.ops.dstorch.kernel_flops(anchor, name, int(flops))


def launch_counts():
    return dict(_launches)


def host_launch_counts():
    return dict(_host_launches)


def reset_launch_counts():
    for counts in (_launches, _host_launches):
        for name in counts:
            counts[name] = 0


def registry_snapshot():
    """Per kernel: its route, source, the TPU kernel it replaces, and
    its launch count so far."""
    return {name: {"route": "cuda", "source": KERNEL_SOURCES[name][0],
                   "replaces": KERNEL_SOURCES[name][1],
                   "launches": _launches[name]}
            for name in KERNEL_NAMES}


def export_gauges(registry):
    """Each kernel's launch count as a pull gauge on a telemetry registry
    (``Kernels/<name>/launches``), rendered at every ``/metrics`` scrape."""
    registry.gauge_fn("Kernels",
                      lambda: {f"{name}/launches": float(n) for name, n in _launches.items()},
                      help="launches of the port's hand-written kernels")
