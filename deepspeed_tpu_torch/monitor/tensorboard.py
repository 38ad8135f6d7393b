"""TensorBoard scalar streams (port of ``deepspeed_tpu/monitor/tensorboard.py``).

The engines' rank-0 scalars (``Train/Samples/{train_loss,lr,loss_scale}``
and the timers, keyed by the global sample count) as TensorBoard event
files, honouring the ``tensorboard`` section (``enabled``,
``output_path``, ``job_name``). The file format is written with the
standard library: TFRecord framing (a length and masked CRC32c around
each record) around hand-encoded ``Event`` protobufs, readable by any
TensorBoard. Writes are buffered: ``record`` may take a device tensor and
keeps it as it is, and only ``flush()`` reads the values on the host, so
monitoring adds no wait for the card to a training step.

``read_events`` parses such a file back, checking both CRCs of every
record.
"""

import os
import socket
import struct
import time


# -- CRC32c (Castagnoli, reflected poly 0x82F63B78) -------------------------

def _make_crc_table():
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _make_crc_table()


def _crc32c(data):
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data):
    crc = _crc32c(data)
    return ((((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF)


# -- minimal protobuf encoding ----------------------------------------------

def _varint(n):
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field, wire):
    return _varint((field << 3) | wire)


def _pb_double(field, value):
    return _key(field, 1) + struct.pack("<d", value)


def _pb_float(field, value):
    return _key(field, 5) + struct.pack("<f", value)


def _pb_int64(field, value):
    return _key(field, 0) + _varint(value & 0xFFFFFFFFFFFFFFFF)


def _pb_bytes(field, data):
    if isinstance(data, str):
        data = data.encode("utf-8")
    return _key(field, 2) + _varint(len(data)) + data


def _event_file_version(wall_time):
    # Event { wall_time=1 (double), file_version=3 (string) }
    return _pb_double(1, wall_time) + _pb_bytes(3, "brain.Event:2")


def _event_scalar(wall_time, step, tag, value):
    # Summary.Value { tag=1, simple_value=2 (float) }
    val = _pb_bytes(1, tag) + _pb_float(2, float(value))
    # Summary { repeated value=1 }
    summary = _pb_bytes(1, val)
    # Event { wall_time=1, step=2, summary=5 }
    return _pb_double(1, wall_time) + _pb_int64(2, int(step)) + _pb_bytes(5, summary)


def _tfrecord(payload):
    header = struct.pack("<Q", len(payload))
    return (header + struct.pack("<I", _masked_crc(header)) + payload
            + struct.pack("<I", _masked_crc(payload)))


# -- reading back ------------------------------------------------------------

def _read_varint(buf, i):
    shift = out = 0
    while True:
        b = buf[i]
        i += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, i
        shift += 7


def _fields(buf):
    """{field: [value, ...]} of a protobuf message (varints as ints, 64-
    and 32-bit fields and length-delimited ones as bytes)."""
    out, i = {}, 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            v, i = _read_varint(buf, i)
        elif wire == 1:
            v, i = buf[i:i + 8], i + 8
        elif wire == 5:
            v, i = buf[i:i + 4], i + 4
        elif wire == 2:
            n, i = _read_varint(buf, i)
            v, i = buf[i:i + n], i + n
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        out.setdefault(field, []).append(v)
    return out


def read_records(path):
    """The payloads of a TFRecord file; a bad length or data CRC raises."""
    with open(path, "rb") as f:
        data = f.read()
    out, i = [], 0
    while i < len(data):
        header = data[i:i + 8]
        (n,) = struct.unpack("<Q", header)
        (len_crc,) = struct.unpack("<I", data[i + 8:i + 12])
        if len_crc != _masked_crc(header):
            raise ValueError(f"{path}: bad length CRC at byte {i}")
        payload = data[i + 12:i + 12 + n]
        (data_crc,) = struct.unpack("<I", data[i + 12 + n:i + 16 + n])
        if len(payload) != n or data_crc != _masked_crc(payload):
            raise ValueError(f"{path}: bad data CRC at byte {i}")
        out.append(payload)
        i += 16 + n
    return out


def read_events(path):
    """The scalar events of an event file as (wall_time, step, tag, value)
    tuples, in file order (the file-version record is skipped)."""
    out = []
    for payload in read_records(path):
        ev = _fields(payload)
        if 5 not in ev:
            continue
        wall = struct.unpack("<d", ev[1][0])[0] if 1 in ev else 0.0
        step = ev.get(2, [0])[0]
        for value in _fields(ev[5][0]).get(1, []):
            v = _fields(value)
            out.append((wall, step, v[1][0].decode("utf-8"),
                        struct.unpack("<f", v[2][0])[0]))
    return out


class SummaryWriter:
    """Append-only scalar event-file writer (a subset of the
    ``torch.utils.tensorboard`` API)."""

    _seq = 0

    def __init__(self, log_dir):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        # pid and a counter of the process: two writers in one second must
        # not truncate each other's file
        SummaryWriter._seq += 1
        fname = (f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}"
                 f".{os.getpid()}.{SummaryWriter._seq}")
        self._path = os.path.join(log_dir, fname)
        self._f = open(self._path, "wb")
        self._f.write(_tfrecord(_event_file_version(time.time())))
        self._f.flush()

    def add_scalar(self, tag, scalar_value, global_step=0, walltime=None):
        wall = time.time() if walltime is None else walltime
        self._f.write(_tfrecord(_event_scalar(wall, global_step, tag, float(scalar_value))))

    def flush(self):
        self._f.flush()

    def close(self):
        if not self._f.closed:
            self._f.flush()
            self._f.close()

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 -- interpreter teardown
            pass


class TensorBoardMonitor:
    """The engines' buffered scalar recorder. ``record()`` takes a Python
    number or a (device) tensor and keeps it; ``flush()`` reads the values
    and writes them. The engines flush every ``steps_per_print`` steps,
    so the event file still holds every step's value."""

    def __init__(self, output_path, job_name, rank=0):
        base = output_path or os.path.join("runs", "deepspeed_tpu")
        self.enabled = rank == 0
        self.writer = SummaryWriter(os.path.join(base, job_name)) if self.enabled else None
        self._pending = []

    def record(self, tag, value, step):
        if self.enabled:
            self._pending.append((tag, value, int(step), time.time()))

    def flush(self):
        if not self.enabled or not self._pending:
            return
        for tag, value, step, wall in self._pending:
            self.writer.add_scalar(tag, float(value), step, walltime=wall)
        self._pending.clear()
        self.writer.flush()

    def close(self):
        if self.enabled:
            self.flush()
            self.writer.close()
