"""Data loading.

Port of ``deepspeed_tpu/runtime/dataloader.py``: ``DistributedSampler``
(the same numpy permutation and strided split, so both packages hand each
replica the same samples in the same order), ``DeepSpeedDataLoader``
(batches of the local micro-batch, collated into tensors),
``RepeatingLoader`` and ``PrefetchLoader``. Datasets are anything
indexable that returns tuples (or dicts) of arrays, tensors or numbers.
"""

import queue
import threading
import time

import numpy as np
import torch

from deepspeed_tpu_torch.utils.logging import logger
from deepspeed_tpu_torch.utils.timer import ThroughputTimer


class DistributedSampler:
    """Deterministic strided sampler over dataset indices for one replica."""

    def __init__(self, num_samples, num_replicas, rank, shuffle=True, seed=0):
        self.num_samples = num_samples
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.samples_per_replica = int(np.ceil(num_samples / num_replicas))

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __iter__(self):
        if self.shuffle:
            indices = np.random.default_rng(self.seed + self.epoch).permutation(self.num_samples)
        else:
            indices = np.arange(self.num_samples)
        # pad to a multiple of the replicas, then take this rank's stride
        total = self.samples_per_replica * self.num_replicas
        if total > len(indices):
            indices = np.concatenate([indices, indices[: total - len(indices)]])
        return iter(indices[self.rank: total: self.num_replicas])

    def __len__(self):
        return self.samples_per_replica


def _stack(values):
    return torch.stack([torch.as_tensor(np.asarray(v)) if not isinstance(v, torch.Tensor)
                        else v for v in values])


class DeepSpeedDataLoader:
    """Batches of ``batch_size`` samples of this replica's share of a
    dataset; a batch is a tuple (or dict) of stacked CPU tensors."""

    def __init__(self, dataset, batch_size, local_rank=0, tput_timer=None, collate_fn=None,
                 num_replicas=1, rank=0, data_sampler=None, shuffle=False, seed=1234):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.tput_timer = tput_timer or ThroughputTimer(batch_size=batch_size, start_step=2)
        if data_sampler is None:
            data_sampler = DistributedSampler(num_samples=len(dataset),
                                              num_replicas=num_replicas, rank=rank,
                                              shuffle=shuffle, seed=seed)
        self.data_sampler = data_sampler
        self.len = len(self.data_sampler) // batch_size
        self.data_iterator = None

    def __len__(self):
        return self.len

    def __iter__(self):
        self.data_iterator = self._create_iterator()
        return self

    def __next__(self):
        if self.data_iterator is None:
            self.data_iterator = self._create_iterator()
        if self.tput_timer:
            self.tput_timer.start(sync=False)   # a host timestamp, no wait on the card
        return next(self.data_iterator)

    def _default_collate(self, samples):
        first = samples[0]
        if isinstance(first, (tuple, list)):
            return tuple(_stack([s[i] for s in samples]) for i in range(len(first)))
        if isinstance(first, dict):
            return {k: _stack([s[k] for s in samples]) for k in first}
        return _stack(samples)

    def _create_iterator(self):
        collate = self.collate_fn or self._default_collate
        batch = []
        for idx in self.data_sampler:
            batch.append(self.dataset[int(idx)])
            if len(batch) == self.batch_size:
                yield collate(batch)
                batch = []


def _to_device(batch, device):
    """A batch's tensors pinned and copied to ``device`` without blocking
    the host (the copy is ordered on the current stream)."""
    if isinstance(batch, torch.Tensor):
        return batch.pin_memory().to(device, non_blocking=True)
    if isinstance(batch, (tuple, list)):
        return type(batch)(_to_device(x, device) for x in batch)
    if isinstance(batch, dict):
        return {k: _to_device(v, device) for k, v in batch.items()}
    return batch


class PrefetchLoader:
    """A background thread that assembles the next ``depth`` batches (and,
    with ``device`` given, starts their copies to the card from pinned host
    memory) while the card runs the current step.

    Wraps any iterable (``DeepSpeedDataLoader``, ``RepeatingLoader``, a
    generator). Exceptions of the source iterator (its end included)
    surface at the matching ``__next__``, in order; once exhausted or
    errored the loader keeps raising ``StopIteration``. ``close()`` (or
    leaving a ``with`` block) stops the worker and drops the prefetched
    batches. The worker is a daemon thread, so an abandoned loader never
    blocks the interpreter's exit."""

    def __init__(self, loader, depth=2, device=None):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self.loader = loader
        self.depth = depth
        self.device = None if device is None else torch.device(device)
        self._queue = queue.Queue(maxsize=depth)
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._started = False
        self._done = False     # latched: exhausted, errored or closed
        self._closed = False

    def _put_device(self, batch):
        if self.device is None or self.device.type == "cpu":
            return batch
        return _to_device(batch, self.device)

    def _worker(self):
        try:
            for batch in self.loader:
                if self._closed:
                    return
                self._queue.put(("ok", self._put_device(batch)))
                if self._closed:
                    return
        except BaseException as e:  # noqa: BLE001 -- re-raised on the consumer side
            self._queue.put(("err", e.with_traceback(e.__traceback__)))
            return
        self._queue.put(("end", None))

    def _ensure_started(self):
        if not self._started:
            self._thread.start()
            self._started = True

    def __iter__(self):
        self._ensure_started()
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        self._ensure_started()
        kind, payload = self._queue.get()
        if kind == "ok":
            return payload
        self._done = True
        if kind == "err":
            # the source's own exception, with its traceback and cause
            raise payload.with_traceback(payload.__traceback__) from payload.__cause__
        raise StopIteration

    def close(self, timeout=5.0):
        """Stop the worker and drop the prefetched batches. Idempotent.
        Waits at most ``timeout`` seconds: a source blocked inside
        ``next()`` cannot be interrupted, and its daemon thread is then
        abandoned."""
        self._closed = True
        self._done = True
        if not self._started:
            return
        deadline = time.monotonic() + timeout
        while self._thread.is_alive() and time.monotonic() < deadline:
            try:
                self._queue.get_nowait()   # unblock a worker stuck in put()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.05)
        if self._thread.is_alive():
            logger.warning(f"PrefetchLoader.close: worker still alive after {timeout}s "
                           "(source iterator blocked in next()?); abandoning the daemon "
                           "thread")
        while True:
            try:
                self._queue.get_nowait()
            except queue.Empty:
                break

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __len__(self):
        return len(self.loader)


class RepeatingLoader:
    """Restarts its loader on ``StopIteration``, advancing the sampler's
    epoch so the shuffle order changes."""

    def __init__(self, loader):
        self.loader = loader
        self.data_iter = iter(self.loader)

    def __iter__(self):
        return self

    def __next__(self):
        try:
            batch = next(self.data_iter)
        except StopIteration:
            sampler = getattr(self.loader, "data_sampler", None)
            if sampler is not None and hasattr(sampler, "set_epoch"):
                sampler.set_epoch(getattr(sampler, "epoch", 0) + 1)
            self.data_iter = iter(self.loader)
            batch = next(self.data_iter)
        return batch
