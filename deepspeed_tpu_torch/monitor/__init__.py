"""The engines' scalar monitors (port of ``deepspeed_tpu/monitor/``)."""

from deepspeed_tpu_torch.monitor.csv_monitor import CsvMonitor
from deepspeed_tpu_torch.monitor.tensorboard import (
    SummaryWriter,
    TensorBoardMonitor,
    read_events,
)


class MultiMonitor:
    """One record / flush / close stream fanned out to several monitors
    (tensorboard and csv both enabled)."""

    def __init__(self, monitors):
        self.monitors = list(monitors)
        self.enabled = any(m.enabled for m in self.monitors)

    def record(self, tag, value, step):
        for m in self.monitors:
            m.record(tag, value, step)

    def flush(self):
        for m in self.monitors:
            m.flush()

    def close(self):
        for m in self.monitors:
            m.close()


def monitor_from_config(config, rank):
    """The configured monitor (None, one monitor or a ``MultiMonitor``),
    the one construction path of every engine. With the ``telemetry``
    block enabled a ``MonitorBridge`` rides along, so every recorded
    scalar also lands in the process-global metrics registry (the
    introspection endpoint's ``/metrics``). Only rank 0 writes."""
    monitors = []
    if config.tensorboard_enabled:
        monitors.append(TensorBoardMonitor(config.tensorboard_output_path,
                                           config.tensorboard_job_name, rank=rank))
    if config.csv_monitor_enabled:
        monitors.append(CsvMonitor(config.csv_monitor_output_path,
                                   config.csv_monitor_job_name, rank=rank))
    tel = getattr(config, "telemetry_config", None)
    if tel is not None and tel.enabled:
        from deepspeed_tpu_torch import telemetry
        monitors.append(telemetry.MonitorBridge(telemetry.get_registry(), rank=rank))
    if not monitors:
        return None
    return monitors[0] if len(monitors) == 1 else MultiMonitor(monitors)


__all__ = ["CsvMonitor", "MultiMonitor", "SummaryWriter", "TensorBoardMonitor",
           "monitor_from_config", "read_events"]
