"""Communication: deadline-bounded control collectives, their named
errors, file-based health gossip, and the tensor collectives over a
process group with their autograd forms.

Port of ``deepspeed_tpu/comm``.
"""

from deepspeed_tpu_torch.comm.comm import (
    HOST_STAGED,
    ReduceOp,
    all_gather,
    all_reduce,
    all_to_all,
    all_to_all_autograd,
    barrier,
    broadcast,
    broadcast_object,
    control_group,
    copy_to_model_region,
    forget_timeout,
    gather_from_model_region,
    gather_sections,
    group_rank,
    group_size,
    host_allreduce_scalar,
    ppermute_send_recv,
    reduce_from_model_region,
    reduce_scatter,
    scatter_to_model_region,
)
from deepspeed_tpu_torch.comm.errors import CommError, CommTimeoutError, DeadPeerError
from deepspeed_tpu_torch.comm.health import HealthGossip

__all__ = [
    "CommError",
    "CommTimeoutError",
    "DeadPeerError",
    "HOST_STAGED",
    "HealthGossip",
    "ReduceOp",
    "all_gather",
    "all_reduce",
    "all_to_all",
    "all_to_all_autograd",
    "barrier",
    "broadcast",
    "broadcast_object",
    "control_group",
    "copy_to_model_region",
    "forget_timeout",
    "gather_from_model_region",
    "gather_sections",
    "group_rank",
    "group_size",
    "host_allreduce_scalar",
    "ppermute_send_recv",
    "reduce_from_model_region",
    "reduce_scatter",
    "scatter_to_model_region",
]
