"""Process-group start-up, rank and world size.

Port of ``deepspeed_tpu/utils/distributed.py``: ``init_distributed``
starts a ``torch.distributed`` process group from the launcher's
environment (``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` /
``MASTER_PORT``), or from MPI discovery when that environment is missing
and an MPI one is present: NCCL when the engine runs on the card, gloo on
the CPU. A single process (no ``WORLD_SIZE``, or 1) with no group asked
for stays a no-op, as in the JAX package. ``get_rank`` / ``get_world_size``
read the group when one is initialized, else the launcher's environment,
else a single process.
"""

import os

import torch

from deepspeed_tpu_torch.utils.logging import logger

TORCH_DISTRIBUTED_DEFAULT_PORT = 29500


def _initialized():
    return torch.distributed.is_available() and torch.distributed.is_initialized()


def init_distributed(dist_backend=None, auto_mpi_discovery=True,
                     distributed_port=TORCH_DISTRIBUTED_DEFAULT_PORT, verbose=True,
                     init_method=None, device_type="cuda"):
    """Start the process group unless one is running. ``dist_backend``
    defaults to NCCL for ``device_type`` "cuda" and gloo otherwise.
    ``init_method`` (a ``file://`` or ``tcp://`` URL) asks for a group
    even at world size 1; without it the group rendezvouses at
    ``MASTER_ADDR:MASTER_PORT``."""
    if _initialized():
        return
    if auto_mpi_discovery and not _required_env_set() and _in_mpi_env():
        if verbose:
            logger.info("Not using the DeepSpeed or launcher env, attempting MPI discovery...")
        mpi_discovery(distributed_port=distributed_port, verbose=verbose)

    world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if world_size <= 1 and init_method is None:
        return
    rank = int(os.environ.get("RANK", "0"))
    backend = dist_backend or ("nccl" if device_type == "cuda" else "gloo")
    if init_method is None:
        port = os.environ.get("MASTER_PORT", distributed_port)
        init_method = f"tcp://{os.environ['MASTER_ADDR']}:{port}"
    if backend == "nccl" and "LOCAL_RANK" in os.environ:
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    if verbose:
        logger.info(f"Initializing torch.distributed ({backend}): {init_method} "
                    f"rank={rank} world_size={world_size}")
    torch.distributed.init_process_group(backend, init_method=init_method, rank=rank,
                                         world_size=world_size)


def _required_env_set():
    return all(k in os.environ for k in ["RANK", "WORLD_SIZE", "MASTER_ADDR"])


def _in_mpi_env():
    return any(k in os.environ for k in ["OMPI_COMM_WORLD_RANK", "PMI_RANK"])


def mpi_discovery(distributed_port=TORCH_DISTRIBUTED_DEFAULT_PORT, verbose=True):
    """Set the launcher's environment from MPI: rank, world size, local
    rank, and rank 0's first address as the master."""
    try:
        from mpi4py import MPI
    except ImportError:
        logger.warning("mpi4py not available, cannot do MPI discovery")
        return
    import subprocess

    comm = MPI.COMM_WORLD
    rank = comm.Get_rank()
    world_size = comm.Get_size()
    master_addr = None
    if rank == 0:
        result = subprocess.check_output(["hostname", "-I"])
        master_addr = result.decode("utf-8").split()[0]
    master_addr = comm.bcast(master_addr, root=0)
    proc_name = MPI.Get_processor_name()
    all_procs = comm.allgather(proc_name)
    local_rank = sum(1 for i in range(rank) if all_procs[i] == proc_name)

    os.environ["RANK"] = str(rank)
    os.environ["WORLD_SIZE"] = str(world_size)
    os.environ["LOCAL_RANK"] = str(local_rank)
    os.environ["MASTER_ADDR"] = master_addr
    os.environ["MASTER_PORT"] = str(distributed_port)
    if verbose:
        logger.info(f"Discovered MPI settings of world_rank={rank}, local_rank={local_rank}, "
                    f"world_size={world_size}, master_addr={master_addr}, "
                    f"master_port={distributed_port}")


def get_rank():
    if _initialized():
        return torch.distributed.get_rank()
    return int(os.environ.get("RANK", "0"))


def get_world_size():
    if _initialized():
        return torch.distributed.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def group_rank_and_size():
    """(rank, world size) of the running group, or (0, 1) without one:
    the data-parallel layout the ZeRO optimizer shards over."""
    if _initialized():
        return torch.distributed.get_rank(), torch.distributed.get_world_size()
    return 0, 1
