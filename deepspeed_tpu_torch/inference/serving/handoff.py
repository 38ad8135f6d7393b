"""Fault-tolerant KV-page handoff for disaggregated prefill/decode.

A copy of ``deepspeed_tpu/inference/serving/handoff.py`` with only the
imports rebound. A prefill-role replica finishes a prompt, exports the
lane's pages as stored (``KVCachePool.export_lane``: storage-dtype bytes
and the int8 scales, so the transfer is bitwise) and ships them to a
decode-role replica over the fleet's line-JSON socket, the page payloads
as length-prefixed binary frames (a big-endian ``(length, crc32)`` header,
a hard size cap, named errors on oversize or corrupt frames; the prefix
cache's spill tier frames its blobs the same way). The decode replica
installs them with ``install_raw`` and resumes the request where prefill
stopped. The protocol has two phases::

    sender                                  receiver
    ------                                  --------
    {"op": "handoff", key, meta, frames} -> claim: allocate a slot
                                         <- {"claimed": true} | rejection
    N binary page frames                 -> verify crc/cap, install_raw
                                         <- {"acked": true} | error doc

- every attempt runs under ``attempt_timeout_s``; failures retry up to
  ``retries`` times with exponential backoff and jitter, and exhaustion
  raises :class:`HandoffRetryError` (the router then re-routes from its
  ``delivered`` mark);
- the claim carries the router's per-attempt handoff key: a re-sent
  handoff whose key is installed is acked again without touching the
  pool, and a retry of an unfinished claim reuses its slot;
- the receiver's claims carry TTLs: a prefill worker that dies
  mid-transfer leaks no slot, and an acked handoff the router never
  resumes returns to the pool. The sender frees its own lane once the
  pages are copied to host memory.
"""

import random
import socket
import struct
import threading
import time
import zlib

from deepspeed_tpu_torch.inference.serving.kv_pool import (
    PageStateError,
    PoolExhaustedError,
)
from deepspeed_tpu_torch.inference.serving.router import (
    PROTOCOL_VERSION,
    read_line,
    send_line,
)

# frame header: payload length + crc32 of the payload, big-endian
_FRAME_HEADER = struct.Struct(">II")
DEFAULT_MAX_FRAME_BYTES = 8 << 20


class HandoffError(RuntimeError):
    """Base class for KV-handoff failures."""


class HandoffSizeError(HandoffError):
    """A frame exceeds the size cap: refused before a payload byte is read
    or sent, so a corrupt length prefix never makes the reader allocate
    gigabytes."""


class HandoffFrameError(HandoffError):
    """A frame arrived torn: truncated header or payload, or a crc32
    mismatch."""


class HandoffTimeoutError(HandoffError):
    """One claim/transfer/ack attempt exceeded its deadline."""


class HandoffRejectedError(HandoffError):
    """The receiver refused the claim."""


class HandoffRetryError(HandoffError):
    """The bounded retry budget is spent. Carries the attempt count and
    the last underlying failure."""

    def __init__(self, key, attempts, last_error):
        self.key = key
        self.attempts = int(attempts)
        self.last_error = str(last_error)
        super().__init__(
            f"handoff {key!r} failed after {attempts} attempt(s); "
            f"last error: {last_error}")


def write_frame(sock, payload, max_bytes=DEFAULT_MAX_FRAME_BYTES):
    """Send one length-prefixed, crc32-protected binary frame through
    ``sock.sendall``."""
    if len(payload) > max_bytes:
        raise HandoffSizeError(
            f"frame of {len(payload)} bytes exceeds the {max_bytes}-byte cap")
    header = _FRAME_HEADER.pack(len(payload), zlib.crc32(payload) & 0xFFFFFFFF)
    sock.sendall(header + payload)


def _read_exact(stream, n):
    chunks = []
    got = 0
    while got < n:
        chunk = stream.read(n - got)
        if not chunk:
            break
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def read_frame(stream, max_bytes=DEFAULT_MAX_FRAME_BYTES):
    """Read one binary frame from ``stream.read``: HandoffFrameError on
    truncation or a crc mismatch, HandoffSizeError on an oversize length
    prefix (raised before the payload is read)."""
    header = _read_exact(stream, _FRAME_HEADER.size)
    if len(header) < _FRAME_HEADER.size:
        raise HandoffFrameError(
            f"truncated frame header ({len(header)} of {_FRAME_HEADER.size} bytes)")
    length, crc = _FRAME_HEADER.unpack(header)
    if length > max_bytes:
        raise HandoffSizeError(f"frame of {length} bytes exceeds the {max_bytes}-byte cap")
    payload = _read_exact(stream, length)
    if len(payload) < length:
        raise HandoffFrameError(
            f"truncated frame payload ({len(payload)} of {length} bytes)")
    if zlib.crc32(payload) & 0xFFFFFFFF != crc:
        raise HandoffFrameError(
            f"frame crc mismatch (expected {crc:#010x}, got "
            f"{zlib.crc32(payload) & 0xFFFFFFFF:#010x})")
    return payload


class HandoffSender:
    """Prefill-side claim→transfer→ack driver with bounded retry.

    ``injector`` (a ServingFaultInjector) lets the chaos harness corrupt
    a frame on the wire or kill the worker mid-transfer — both faults
    the protocol must survive."""

    def __init__(self, config=None, injector=None, rng=None):
        from deepspeed_tpu_torch.inference.serving.config import HandoffConfig
        self.config = config or HandoffConfig()
        self.injector = injector
        self._rng = rng or random.Random()
        self.counters = {"attempts": 0, "retries": 0, "acked": 0,
                         "dup_acked": 0, "failed": 0, "frame_errors": 0}

    def send(self, host, port, key, meta, frames):
        """Run the full protocol against ``host:port``; returns the ack
        doc. Raises HandoffRetryError once the retry budget is spent."""
        cfg = self.config
        budget = max(1, int(cfg.retries))
        last = None
        for attempt in range(1, budget + 1):
            self.counters["attempts"] += 1
            try:
                ack = self._attempt(host, port, key, meta, frames)
                self.counters["acked"] += 1
                if ack.get("dup"):
                    self.counters["dup_acked"] += 1
                return ack
            except (HandoffError, OSError) as e:
                last = e
                if isinstance(e, HandoffFrameError):
                    self.counters["frame_errors"] += 1
                if attempt < budget:
                    self.counters["retries"] += 1
                    base = cfg.backoff_s * (2 ** (attempt - 1))
                    delay = min(base, cfg.backoff_max_s)
                    time.sleep(delay * (0.5 + self._rng.random()))
        self.counters["failed"] += 1
        raise HandoffRetryError(key, budget, last)

    def _attempt(self, host, port, key, meta, frames):
        cfg = self.config
        timeout = float(cfg.attempt_timeout_s) or None
        try:
            with socket.create_connection((host, int(port)),
                                          timeout=timeout) as sock:
                sock.settimeout(timeout)
                stream = sock.makefile("rb")
                send_line(sock, {"op": "handoff", "v": PROTOCOL_VERSION,
                                 "key": key, "meta": meta,
                                 "frames": len(frames)})
                reply = read_line(stream)
                if reply is None:
                    raise HandoffFrameError("EOF awaiting claim reply")
                if reply.get("acked"):
                    return reply            # idempotent duplicate
                if not reply.get("claimed"):
                    raise HandoffRejectedError(
                        f"claim refused: {reply!r}")
                for idx, payload in enumerate(frames):
                    self._write_frame(sock, payload)
                    if self.injector is not None:
                        self.injector.maybe_kill_mid_transfer(idx + 1)
                reply = read_line(stream)
                if reply is None:
                    raise HandoffFrameError("EOF awaiting ack")
                if reply.get("acked"):
                    return reply
                etype = reply.get("etype", "")
                if etype in ("HandoffFrameError", "HandoffSizeError"):
                    raise HandoffFrameError(
                        f"receiver refused a frame: {reply.get('error')}")
                raise HandoffRejectedError(f"no ack: {reply!r}")
        except socket.timeout as e:
            raise HandoffTimeoutError(
                f"handoff attempt to {host}:{port} exceeded "
                f"{cfg.attempt_timeout_s}s") from e

    def _write_frame(self, sock, payload):
        """write_frame, plus the corrupt_handoff_frame arm: the header's
        crc is computed BEFORE the flip (simulating wire corruption), so
        the receiver's crc check must catch it."""
        cap = int(self.config.max_frame_bytes)
        if len(payload) > cap:
            raise HandoffSizeError(
                f"frame of {len(payload)} bytes exceeds the {cap}-byte cap")
        header = _FRAME_HEADER.pack(len(payload),
                                    zlib.crc32(payload) & 0xFFFFFFFF)
        if (payload and self.injector is not None
                and self.injector.corrupt_handoff_frame()):
            payload = bytes([payload[0] ^ 0xFF]) + payload[1:]
        sock.sendall(header + payload)


class _Claim:
    __slots__ = ("key", "slot", "state", "meta", "born")

    def __init__(self, key, slot, meta, now):
        self.key = key
        self.slot = slot
        self.state = "claimed"          # -> "installed"
        self.meta = meta
        self.born = now


class HandoffReceiver:
    """Decode-side claim/install/ack state machine + orphan reaper.

    Pool access goes through three engine-provided callables (they run
    on the engine loop thread so claims never race admissions):
    ``allocate_fn(n_tokens) -> slot``, ``install_fn(slot, meta, frames,
    key) -> bool`` and ``free_fn(slot)``."""

    def __init__(self, config, allocate_fn, install_fn, free_fn,
                 clock=time.monotonic, on_event=None):
        from deepspeed_tpu_torch.inference.serving.config import HandoffConfig
        self.config = config or HandoffConfig()
        self._allocate = allocate_fn
        self._install = install_fn
        self._free = free_fn
        self._clock = clock
        self._on_event = on_event       # on_event(name) -> None, optional
        self._claims = {}               # key -> _Claim
        self._lock = threading.Lock()
        self.counters = {"claims": 0, "installs": 0, "dup_acks": 0,
                         "frame_errors": 0, "reaped_claimed": 0,
                         "reaped_installed": 0, "resumed": 0,
                         "rejected": 0}

    def _event(self, name):
        if self._on_event is not None:
            try:
                self._on_event(name)
            except Exception:
                pass

    # -- the "handoff" socket op ----------------------------------------
    def handle(self, conn, stream, op, reply_fn):
        """Serve one handoff op on an open connection: claim, read the
        binary frames, install, ack. The claim survives a torn transfer
        (the sender retries under the same key); only the TTL reaper
        frees it."""
        self.reap()
        key = str(op.get("key") or "")
        meta = op.get("meta")
        nframes = int(op.get("frames", 0))
        if not key or not isinstance(meta, dict):
            reply_fn(conn, {"error": "handoff without key/meta",
                            "etype": "ValueError"})
            return
        with self._lock:
            claim = self._claims.get(key)
            if claim is not None and claim.state == "installed":
                self.counters["dup_acks"] += 1
                reply_fn(conn, {"acked": True, "key": key, "dup": True})
                return
        if claim is None:
            reserve = int(meta.get("reserve_tokens")
                          or meta.get("position") or 1)
            try:
                slot = self._allocate(reserve)
            except PoolExhaustedError as e:
                self.counters["rejected"] += 1
                reply_fn(conn, {"rejected": "pool_exhausted",
                                "detail": str(e)})
                return
            claim = _Claim(key, slot, meta, self._clock())
            with self._lock:
                self._claims[key] = claim
            self.counters["claims"] += 1
        reply_fn(conn, {"claimed": True, "key": key, "slot": claim.slot})
        cap = int(self.config.max_frame_bytes)
        try:
            frames = [read_frame(stream, cap) for _ in range(nframes)]
        except (HandoffFrameError, HandoffSizeError) as e:
            # claim kept: the sender retries the transfer under the same
            # key; a dead sender's claim falls to the TTL reaper
            self.counters["frame_errors"] += 1
            self._event("frame_error")
            reply_fn(conn, {"error": str(e), "etype": type(e).__name__,
                            "key": key})
            return
        except OSError:
            return                      # sender died mid-transfer
        try:
            fresh = self._install(claim.slot, meta, frames, key)
        except (PageStateError, ValueError) as e:
            reply_fn(conn, {"error": str(e), "etype": type(e).__name__,
                            "key": key})
            return
        claim.state = "installed"
        claim.born = self._clock()      # installed TTL starts now
        if fresh:
            self.counters["installs"] += 1
        else:
            self.counters["dup_acks"] += 1
        reply_fn(conn, {"acked": True, "key": key,
                        "pages": int(meta.get("pages", nframes)),
                        "dup": not fresh})

    # -- resume (the router's second hop claims the installed lane) -----
    def take(self, key):
        """Pop an INSTALLED claim for resumption; returns (slot, meta)
        or None (unknown key, or transfer never finished). Once taken,
        the slot belongs to the engine's resumed request — the reaper
        will not touch it."""
        with self._lock:
            claim = self._claims.get(key)
            if claim is None or claim.state != "installed":
                return None
            del self._claims[key]
        self.counters["resumed"] += 1
        return claim.slot, claim.meta

    def restore(self, key, slot, meta):
        """Undo a take() whose resume failed before the engine owned the
        slot, so the reaper can still free it."""
        with self._lock:
            self._claims[key] = _Claim(key, slot, meta, self._clock())
            self._claims[key].state = "installed"

    # -- the orphan reaper ----------------------------------------------
    def reap(self, now=None):
        """Free claims past their TTL: ``claim_ttl_s`` for transfers
        that never finished (prefill worker died mid-handoff),
        ``resume_ttl_s`` for installed lanes the router never resumed
        (it re-routed, or died). Returns the number of slots freed."""
        now = self._clock() if now is None else now
        expired = []
        with self._lock:
            for key, claim in list(self._claims.items()):
                ttl = (self.config.claim_ttl_s if claim.state == "claimed"
                       else self.config.resume_ttl_s)
                if now - claim.born > ttl:
                    expired.append(claim)
                    del self._claims[key]
        for claim in expired:
            if claim.state == "claimed":
                self.counters["reaped_claimed"] += 1
            else:
                self.counters["reaped_installed"] += 1
            self._event("reaped")
            try:
                self._free(claim.slot)
            except (PageStateError, ValueError):
                pass                    # already freed elsewhere
        return len(expired)

    def pending(self):
        with self._lock:
            return len(self._claims)
