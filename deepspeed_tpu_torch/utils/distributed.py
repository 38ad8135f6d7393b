"""Process rank and world size for the data loader (``get_rank`` and
``get_world_size`` of ``deepspeed_tpu/utils/distributed.py``): the
``torch.distributed`` group when one is initialized, else the launcher's
``RANK`` / ``WORLD_SIZE`` environment, else a single process."""

import os

import torch


def _initialized():
    return torch.distributed.is_available() and torch.distributed.is_initialized()


def get_rank():
    if _initialized():
        return torch.distributed.get_rank()
    return int(os.environ.get("RANK", "0"))


def get_world_size():
    if _initialized():
        return torch.distributed.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))
