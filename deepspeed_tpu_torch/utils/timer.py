"""Wall-clock and throughput timers (port of
``deepspeed_tpu/utils/timer.py``): ``SynchronizedWallClockTimer``, named
timers bracketed by a wait for the card, whose ``log()`` prints the
elapsed ms, and ``ThroughputTimer``, samples/s over a training window."""

import time

import torch

from deepspeed_tpu_torch.utils.logging import log_dist


def _device_sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class SynchronizedWallClockTimer:
    """Named wall-clock timers, each start and stop bracketed by
    ``torch.cuda.synchronize(device)`` on the card (nothing on the CPU)
    unless called with ``sync=False``. ``elapsed_`` accumulates until
    ``elapsed(reset=True)`` (and so ``log()``) resets it."""

    class Timer:
        def __init__(self, name, sync_fn):
            self.name_ = name
            self.elapsed_ = 0.0
            self.started_ = False
            self.start_time = 0.0
            self._sync = sync_fn

        def start(self, sync=True):
            assert not self.started_, f"timer {self.name_} has already been started"
            if sync:
                self._sync()
            self.start_time = time.time()
            self.started_ = True

        def stop(self, sync=True, reset=False):
            assert self.started_, f"timer {self.name_} is not started"
            if sync:
                self._sync()
            if reset:
                self.elapsed_ = time.time() - self.start_time
            else:
                self.elapsed_ += time.time() - self.start_time
            self.started_ = False

        def reset(self):
            self.elapsed_ = 0.0
            self.started_ = False

        def elapsed(self, reset=True):
            started = self.started_
            if started:
                self.stop()
            elapsed_ = self.elapsed_
            if reset:
                self.reset()
            if started:
                self.start()
            return elapsed_

    def __init__(self, device=None):
        self.timers = {}
        self.device = torch.device(device) if device is not None else None

    def _sync(self):
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __call__(self, name):
        if name not in self.timers:
            self.timers[name] = self.Timer(name, self._sync)
        return self.timers[name]

    def memory_usage(self):
        """The card's allocated and peak allocated memory (GiB)."""
        if self.device is None or self.device.type != "cuda":
            return "MemAllocated=? PeakAllocated=?"
        in_use = torch.cuda.memory_allocated(self.device) / (1024**3)
        peak = torch.cuda.max_memory_allocated(self.device) / (1024**3)
        return f"MemAllocated={in_use:.3f} GB PeakAllocated={peak:.3f} GB"

    def log(self, names, normalizer=1.0, reset=True, ranks=None, memory_breakdown=False):
        assert normalizer > 0.0
        string = "time (ms)"
        for name in names:
            if name in self.timers:
                elapsed_time = self.timers[name].elapsed(reset=reset) * 1000.0 / normalizer
                string += f" | {name}: {elapsed_time:.2f}"
        if memory_breakdown:
            string += " | " + self.memory_usage()
        log_dist(string, ranks=ranks or [0])
        return string


class ThroughputTimer:
    """Samples/s after ``start_step`` warm-up steps. ``start(sync=False)``
    takes a host timestamp without draining the device queue; the
    window's device time is absorbed by the synchronizing ``stop`` at a
    report boundary."""

    def __init__(self, batch_size, num_workers=1, start_step=2, steps_per_output=50,
                 logging_fn=None):
        self.start_time = 0
        self.started = False
        self.batch_size = max(1, batch_size)
        self.num_workers = num_workers
        self.start_step = start_step
        self.micro_step_count = 0
        self.global_step_count = 0
        self.total_elapsed_time = 0
        self.steps_per_output = steps_per_output
        self.logging = logging_fn or print

    def start(self, sync=True):
        self.started = True
        if self.global_step_count >= self.start_step:
            if sync:
                _device_sync()
            self.start_time = time.time()

    def stop(self, report_speed=True, sync=True):
        if not self.started:
            return
        self.started = False
        self.micro_step_count += 1
        self.global_step_count += 1
        if self.start_time > 0:
            if sync:
                _device_sync()
            self.total_elapsed_time += time.time() - self.start_time
            if report_speed and self.global_step_count % self.steps_per_output == 0:
                sps = self.avg_samples_per_sec()
                if sps is not None:
                    self.logging(f"{self.global_step_count}/{self.micro_step_count}, "
                                 f"SamplesPerSec={sps:.2f}")

    def avg_samples_per_sec(self):
        """Windowed samples/s, or None until the warm-up window is over."""
        if self.global_step_count > self.start_step and self.total_elapsed_time > 0:
            steps = self.global_step_count - self.start_step
            return self.batch_size * self.num_workers / (self.total_elapsed_time / steps)
        return None
