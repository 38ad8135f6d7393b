"""Rank-aware logging (port of ``deepspeed_tpu/utils/logging.py``): one
framework logger and ``log_dist(message, ranks)``, with the rank from
``torch.distributed`` when it is initialized, else ``RANK``, else 0."""

import logging
import os
import sys

import torch

log_levels = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "critical": logging.CRITICAL,
}


def _create_logger(name, level):
    logger_ = logging.getLogger(name)
    logger_.setLevel(level)
    logger_.propagate = False
    if not logger_.handlers:
        handler = logging.StreamHandler(stream=sys.stderr)
        handler.setLevel(level)
        handler.setFormatter(logging.Formatter(
            "[%(asctime)s] [%(levelname)s] [%(filename)s:%(lineno)d:%(funcName)s] %(message)s"))
        logger_.addHandler(handler)
    return logger_


logger = _create_logger(
    "DeepSpeedTorch",
    log_levels.get(os.environ.get("DSTORCH_LOG_LEVEL", "info"), logging.INFO))


def get_rank():
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_rank()
    return int(os.environ.get("RANK", 0))


def log_dist(message, ranks=None, level=logging.INFO):
    """Log ``message`` only on the given ranks (None or [-1]: all)."""
    my_rank = get_rank()
    if ranks is None or -1 in ranks or my_rank in ranks:
        logger.log(level, f"[Rank {my_rank}] {message}")
