"""Samples/s over a training window (port of ``ThroughputTimer`` of
``deepspeed_tpu/utils/timer.py``)."""

import time

import torch


def _device_sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


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
