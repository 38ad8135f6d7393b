"""CSV scalar monitor (port of ``deepspeed_tpu/monitor/csv_monitor.py``):
the ``TensorBoardMonitor``'s buffered record / flush interface, one CSV
file a scalar tag.

Config::

    "csv_monitor": {"enabled": true,
                    "output_path": "runs/",             # default
                    "job_name": "DeepSpeedTPUJobName"}  # default
"""

import atexit
import os
import time

# a run that dies between flushes loses at most this many rows (the atexit
# hook catches a clean interpreter exit)
_AUTO_FLUSH_EVERY = 256


class CsvMonitor:
    """One ``<output_path>/<job_name>/<tag>.csv`` a tag, rows
    ``step,value,walltime``. ``record`` keeps the value as given (a device
    tensor too); ``flush`` reads the values and appends them."""

    def __init__(self, output_path, job_name, rank=0, auto_flush_every=_AUTO_FLUSH_EVERY):
        base = output_path or os.path.join("runs", "deepspeed_tpu")
        self.enabled = rank == 0
        self.dir = os.path.join(base, job_name)
        if self.enabled:
            os.makedirs(self.dir, exist_ok=True)
        self._pending = []
        self._headers_written = set()
        self._auto_flush_every = int(auto_flush_every)
        if self.enabled:
            atexit.register(self.flush)

    def record(self, tag, value, step):
        if self.enabled:
            self._pending.append((tag, value, int(step), time.time()))
            if len(self._pending) >= self._auto_flush_every:
                self.flush()

    def _path(self, tag):
        safe = "".join(c if (c.isalnum() or c in "-_.") else "_" for c in tag)
        return os.path.join(self.dir, f"{safe}.csv")

    def flush(self):
        if not self.enabled or not self._pending:
            return
        by_tag = {}
        for tag, value, step, wall in self._pending:
            by_tag.setdefault(tag, []).append((step, float(value), wall))
        self._pending.clear()
        for tag, rows in by_tag.items():
            # a tag's first write in this run truncates: appending to an
            # earlier run's file would interleave two runs' steps
            new = tag not in self._headers_written
            with open(self._path(tag), "w" if new else "a") as f:
                if new:
                    f.write("step,value,walltime\n")
                for step, value, wall in rows:
                    f.write(f"{step},{value},{wall}\n")
            self._headers_written.add(tag)

    def close(self):
        self.flush()
        if self.enabled:
            atexit.unregister(self.flush)
