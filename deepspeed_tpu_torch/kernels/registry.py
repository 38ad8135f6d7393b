"""The port's kernel registry: names, backends and launch counts.

The JAX registry probes each Pallas kernel at first use and degrades to
the composed-XLA fallback when the probe fails. The port has no such
machinery: a wrapper given a CUDA tensor launches its hand-written
kernel or raises, and a wrapper given a CPU tensor runs the kernel's
plain PyTorch version. What stays is the bookkeeping: which kernel sits
behind which ``attention_impl`` backend, and a plain per-kernel count of
launches that each wrapper bumps where it launches its kernel (and
nowhere else), so a run can show that its main path went through the
kernels. The host Adam of ZeRO-Offload (``csrc/cpu_adam.cpp``, built with
``g++``) is counted apart from the CUDA kernels (``host_launch_counts``).
"""

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

# the host kernel, its source, and the JAX package's host kernel it ports
HOST_KERNEL_NAMES = ("cpu_adam",)
HOST_KERNEL_SOURCES = {"cpu_adam": ("deepspeed_tpu_torch/csrc/cpu_adam.cpp",
                                    "csrc/cpu_adam.cpp:15")}

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
