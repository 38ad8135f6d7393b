"""Hand-written Hopper kernels of the port, each beside its plain version.

Counterpart of ``deepspeed_tpu/kernels``. Each kernel is CUDA C++ for
``sm_90a`` under ``deepspeed_tpu_torch/csrc``, built by ``build.py`` at
first use and bound through a plain C interface. A wrapper given CUDA
tensors launches its kernel (or raises); given CPU tensors it runs the
kernel's plain PyTorch version. Kernels:

- ``decode_attention`` — paged causal attention with an online softmax
  across a lane's page table; int8 pages consumed directly.
- ``sparse_attention`` — banded sink+window attention, one query per
  block.

The training path's three flash-attention kernels (forward, dq, dk/dv)
live beside their plain versions in
``deepspeed_tpu_torch/ops/transformer/attention.py``, where the JAX
package keeps their Pallas counterparts; they are registered here too, and so is the host Adam of ZeRO-Offload
(``ops/adam/cpu_adam.py``).
"""

from deepspeed_tpu_torch.kernels.registry import (
    KERNEL_BACKENDS,
    KERNEL_NAMES,
    host_launch_counts,
    kernel_for_backend,
    launch_counts,
    record_launch,
    registry_snapshot,
    reset_launch_counts,
)
from deepspeed_tpu_torch.kernels.decode_attention import (
    chunk_attend,
    decode_attend,
)
from deepspeed_tpu_torch.kernels.sparse_attention import (
    band_attend,
    chunk_band_attend,
)

__all__ = [
    "KERNEL_BACKENDS",
    "KERNEL_NAMES",
    "band_attend",
    "chunk_attend",
    "chunk_band_attend",
    "decode_attend",
    "host_launch_counts",
    "kernel_for_backend",
    "launch_counts",
    "record_launch",
    "registry_snapshot",
    "reset_launch_counts",
]
