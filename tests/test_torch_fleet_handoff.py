"""The port's disaggregated prefill/decode handoff: the KV-page transfer
between a prefill and a decode replica.

The JAX package's ``tests/unit/test_disagg.py`` fast tier on the port's
copies: the length-prefixed crc32 frame codec, the pool's page-state
guards and the raw ``export_lane`` -> ``install_raw`` round trip (bit
for bit in fp32, bf16 and int8, with the meta keys and frame lengths of
the JAX pool's export at the same geometry), the ``HandoffReceiver``
claim/install/ack state machine with an injected clock driving both
orphan-reaper TTLs, the ``HandoffSender``'s bounded retry against a
scripted stub, the router's role-aware routing and the role-pool
autoscaler. Then real engines (tiny GPT-2 on the CPU): prefill engine ->
export -> install -> resume on a decode engine equals a mixed admission
and the port's ``generate()`` bit for bit, and the JAX ``generate()`` on
the same weights; the same over sockets through the router, sender and
receiver. The subprocess chaos test is ``slow``, as the JAX package
marks its own.
"""

import socket
import struct
import threading
import time
import zlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from deepspeed_tpu.inference.generation import generate as jgenerate  # noqa: E402
from deepspeed_tpu.inference.serving.kv_pool import KVCachePool as JKVCachePool  # noqa: E402
from deepspeed_tpu.models.gpt2 import GPT2Config as JGPT2Config  # noqa: E402
from deepspeed_tpu.models.gpt2 import init_gpt2 as jinit_gpt2  # noqa: E402
from deepspeed_tpu_torch.inference.generation import generate  # noqa: E402
from deepspeed_tpu_torch.inference.serving import (  # noqa: E402
    FleetConfig,
    HandoffConfig,
    HandoffFrameError,
    HandoffReceiver,
    HandoffRetryError,
    HandoffSender,
    HandoffSizeError,
    KVCachePool,
    PageStateError,
    PoolExhaustedError,
    ReplicaEndpoint,
    ReplicaServer,
    RolesConfig,
    Router,
    ServingConfig,
    ServingEngine,
    ServingFaultInjector,
    WrongRoleError,
)
from deepspeed_tpu_torch.inference.serving.autoscaler import (  # noqa: E402
    ProcessReplicaSpawner,
    RolePoolAutoscaler,
)
from deepspeed_tpu_torch.inference.serving.chaos import DisaggChaosHarness  # noqa: E402
from deepspeed_tpu_torch.inference.serving.config import AutoscaleConfig  # noqa: E402
from deepspeed_tpu_torch.inference.serving.handoff import (  # noqa: E402
    read_frame,
    write_frame,
)
from deepspeed_tpu_torch.inference.serving.router import read_line, send_line  # noqa: E402
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHeadModel  # noqa: E402
from tests.test_torch_fleet_router import (  # noqa: E402,F401  (stubs: fixture re-export)
    FAST_CFG,
    StubReplica,
    make_router,
    stub_tokens,
    stubs,
)



def _crc(payload):
    return zlib.crc32(payload) & 0xFFFFFFFF


def _pair():
    a, b = socket.socketpair()
    a.settimeout(5.0)
    b.settimeout(5.0)
    return a, b


# ---------------------------------------------------------------------------
# fast tier: the binary frame codec
# ---------------------------------------------------------------------------

def test_frame_roundtrip_bitwise():
    a, b = _pair()
    try:
        payload = bytes(range(256)) * 7
        write_frame(a, payload)
        assert read_frame(b.makefile("rb")) == payload
    finally:
        a.close()
        b.close()


def test_frame_oversize_refused_on_send():
    a, b = _pair()
    try:
        with pytest.raises(HandoffSizeError):
            write_frame(a, b"x" * 100, max_bytes=64)
    finally:
        a.close()
        b.close()


def test_frame_oversize_refused_before_payload_read():
    # a hostile/corrupt header claiming 1 GiB must be refused from the
    # header alone — no payload follows, and read_frame must not block
    # trying to consume one
    a, b = _pair()
    try:
        a.sendall(struct.pack(">II", 1 << 30, 0))
        a.close()
        with pytest.raises(HandoffSizeError):
            read_frame(b.makefile("rb"), max_bytes=1 << 20)
    finally:
        b.close()


def test_frame_truncated_payload_named():
    a, b = _pair()
    try:
        payload = b"hello world"
        a.sendall(struct.pack(">II", len(payload) + 5, _crc(payload)))
        a.sendall(payload)
        a.close()                       # EOF before the promised bytes
        with pytest.raises(HandoffFrameError, match="truncated|EOF|short"):
            read_frame(b.makefile("rb"))
    finally:
        b.close()


def test_frame_crc_mismatch_named():
    a, b = _pair()
    try:
        payload = b"page bytes here"
        corrupt = bytes([payload[0] ^ 0xFF]) + payload[1:]
        a.sendall(struct.pack(">II", len(payload), _crc(payload)) + corrupt)
        a.close()
        with pytest.raises(HandoffFrameError, match="crc"):
            read_frame(b.makefile("rb"))
    finally:
        b.close()


# ---------------------------------------------------------------------------
# fast tier: KV pool page-state guards + raw export/install (satellite)
# ---------------------------------------------------------------------------

def _pool(dt="fp32", n_layers=1, n_heads=1):
    # multi-page lanes: 16-token lanes in 4-token pages
    return KVCachePool(n_layers=n_layers, max_slots=2, n_heads=n_heads, max_seq_len=16,
                       head_dim=4, kv_cache_dtype=dt, page_tokens=4, device="cpu")


def _lane_kv(n_layers=1, n_heads=1, seed=3):
    rng = np.random.RandomState(seed)
    shape = (n_layers, 1, n_heads, 16, 4)
    return rng.randn(*shape).astype(np.float32), rng.randn(*shape).astype(np.float32)


def _filled_slot(pool, n_tokens=8, position=6, seed=3):
    slot = pool.allocate(n_tokens)
    k, v = _lane_kv(pool.n_layers, pool.n_heads, seed)
    pool.install(torch.from_numpy(k), torch.from_numpy(v), slot, position)
    return slot


def test_pool_double_free_is_named_page_state_error():
    pool = _pool()
    slot = pool.allocate(4)
    pool.free(slot)
    with pytest.raises(PageStateError, match="double free"):
        pool.free(slot)
    # PageStateError must stay a ValueError: pre-existing callers catch
    # the broad class
    assert issubclass(PageStateError, ValueError)


@pytest.mark.parametrize("dt", ["fp32", "bf16", "int8"])
def test_pool_export_install_raw_roundtrip_bitwise(dt):
    src, dst = _pool(dt), _pool(dt)
    slot = _filled_slot(src, n_tokens=8, position=6)
    meta, frames = src.export_lane(slot)
    assert meta["pages"] == 2
    assert meta["position"] == 6
    assert meta["kv_cache_dtype"] == dt
    assert len(frames) == meta["pages"] + (1 if dt == "int8" else 0)
    tgt = dst.allocate(8)
    assert dst.install_raw(tgt, meta, frames, handoff_key="hk") is True
    meta2, frames2 = dst.export_lane(tgt)
    # the installed lane re-exports bit-identically: bytes, position,
    # scales and all
    assert frames2 == frames
    assert meta2 == meta
    assert dst.handoff_slot("hk") == tgt


def test_pool_install_raw_idempotent_under_same_key():
    src, dst = _pool(), _pool()
    slot = _filled_slot(src)
    meta, frames = src.export_lane(slot)
    tgt = dst.allocate(8)
    assert dst.install_raw(tgt, meta, frames, handoff_key="hk") is True
    # a re-sent handoff under the live key is a no-op, never a second
    # install
    assert dst.install_raw(tgt, meta, frames, handoff_key="hk") is False
    # ... while a DIFFERENT key aimed at the live lane is a bug, loudly
    with pytest.raises(PageStateError, match="already holds"):
        dst.install_raw(tgt, meta, frames, handoff_key="other")
    # freeing the lane retires the key: the slot is reusable
    dst.free(tgt)
    assert dst.handoff_slot("hk") is None
    tgt2 = dst.allocate(8)
    assert dst.install_raw(tgt2, meta, frames, handoff_key="hk") is True


def test_pool_install_raw_refuses_dtype_and_page_mismatch():
    src = _pool("fp32")
    slot = _filled_slot(src)
    meta, frames = src.export_lane(slot)
    wrong_dt = _pool("int8")
    tgt = wrong_dt.allocate(8)
    with pytest.raises(PageStateError, match="dtype"):
        wrong_dt.install_raw(tgt, meta, frames)
    small = _pool("fp32")
    tiny = small.allocate(4)            # one page < the export's two
    with pytest.raises(PageStateError, match="pages"):
        small.install_raw(tiny, meta, frames)


def test_pool_install_raw_into_free_slot_refused():
    src, dst = _pool(), _pool()
    meta, frames = src.export_lane(_filled_slot(src))
    tgt = dst.allocate(8)
    dst.free(tgt)
    with pytest.raises(PageStateError, match="not allocated"):
        dst.install_raw(tgt, meta, frames, handoff_key="hk")


# ---------------------------------------------------------------------------
# fast tier: HandoffReceiver state machine (claim -> transfer -> ack)
# ---------------------------------------------------------------------------

class _FakePool:
    """Slot bookkeeping without device state, counting every call."""

    def __init__(self, slots=4):
        self._free = list(range(slots))
        self.alloc_calls = 0
        self.installed = {}             # slot -> key
        self.freed = []

    def allocate(self, n_tokens):
        self.alloc_calls += 1
        if not self._free:
            raise PoolExhaustedError("no free slots")
        return self._free.pop(0)

    def install(self, slot, meta, frames, key):
        if key in self.installed.values():
            return False                # idempotent duplicate
        self.installed[slot] = key
        return True

    def free(self, slot):
        self.freed.append(slot)
        self.installed.pop(slot, None)
        self._free.append(slot)


def _receiver(pool, clock=None, **cfg):
    kw = dict(enabled=True, retries=3, backoff_s=0.001, backoff_max_s=0.002,
              attempt_timeout_s=5.0, claim_ttl_s=1.0, resume_ttl_s=3.0)
    kw.update(cfg)
    return HandoffReceiver(HandoffConfig(**kw), allocate_fn=pool.allocate,
                           install_fn=pool.install, free_fn=pool.free,
                           clock=clock or time.monotonic)


def _frame_bytes(frames):
    return b"".join(struct.pack(">II", len(p), _crc(p)) + p for p in frames)


def _drive(rcv, key, meta, frames, raw=None):
    """Feed one handoff op into the receiver over a socketpair; returns
    the reply docs in order."""
    a, b = _pair()
    replies = []
    try:
        a.sendall(_frame_bytes(frames) if raw is None else raw)
        a.shutdown(socket.SHUT_WR)
        rcv.handle(b, b.makefile("rb"),
                   {"op": "handoff", "key": key, "meta": meta,
                    "frames": len(frames)},
                   lambda _conn, doc: replies.append(doc))
    finally:
        a.close()
        b.close()
    return replies


META = {"pages": 2, "position": 6, "reserve_tokens": 12}
FRAMES = [b"k-page-0v-page-0", b"k-page-1v-page-1"]


def test_receiver_claim_transfer_ack():
    pool = _FakePool()
    rcv = _receiver(pool)
    replies = _drive(rcv, "hk", META, FRAMES)
    assert replies[0] == {"claimed": True, "key": "hk", "slot": 0}
    assert replies[1] == {"acked": True, "key": "hk", "pages": 2,
                          "dup": False}
    assert pool.installed == {0: "hk"}
    assert rcv.pending() == 1           # installed, awaiting resume
    assert rcv.take("hk") == (0, META)
    assert rcv.pending() == 0
    assert rcv.take("hk") is None       # gone once taken


def test_receiver_duplicate_resend_acks_without_second_install():
    pool = _FakePool()
    rcv = _receiver(pool)
    _drive(rcv, "hk", META, FRAMES)
    replies = _drive(rcv, "hk", META, FRAMES)
    # the dup short-circuits before the allocator: exactly-once install
    assert replies == [{"acked": True, "key": "hk", "dup": True}]
    assert pool.alloc_calls == 1
    assert rcv.counters["dup_acks"] == 1


def test_receiver_frame_error_keeps_claim_and_retry_reuses_slot():
    pool = _FakePool()
    rcv = _receiver(pool)
    bad = bytes([FRAMES[0][0] ^ 0xFF]) + FRAMES[0][1:]
    raw = (struct.pack(">II", len(FRAMES[0]), _crc(FRAMES[0])) + bad
           + _frame_bytes(FRAMES[1:]))
    replies = _drive(rcv, "hk", META, FRAMES, raw=raw)
    assert replies[0]["claimed"]
    assert replies[1]["etype"] == "HandoffFrameError"
    # the torn transfer's claim survives for the sender's retry ...
    assert rcv.pending() == 1
    assert pool.freed == []
    # ... which lands on the SAME slot without a second allocation
    replies = _drive(rcv, "hk", META, FRAMES)
    assert replies[0] == {"claimed": True, "key": "hk", "slot": 0}
    assert replies[1]["acked"] and not replies[1]["dup"]
    assert pool.alloc_calls == 1
    assert rcv.counters["frame_errors"] == 1


def test_receiver_rejects_on_pool_exhaustion():
    pool = _FakePool(slots=0)
    rcv = _receiver(pool)
    replies = _drive(rcv, "hk", META, FRAMES)
    assert replies == [{"rejected": "pool_exhausted",
                        "detail": "no free slots"}]
    assert rcv.counters["rejected"] == 1


def test_receiver_reaps_orphans_on_both_ttls():
    t = [0.0]
    pool = _FakePool()
    rcv = _receiver(pool, clock=lambda: t[0], claim_ttl_s=1.0,
                    resume_ttl_s=3.0)
    # orphaned CLAIM: the prefill worker died mid-transfer (frame error
    # path leaves the claim in "claimed")
    raw = struct.pack(">II", len(FRAMES[0]), _crc(FRAMES[0]) ^ 1) + FRAMES[0]
    _drive(rcv, "dead-sender", META, [FRAMES[0]], raw=raw)
    assert rcv.pending() == 1
    t[0] = 0.5
    assert rcv.reap() == 0              # inside claim_ttl_s: kept
    t[0] = 1.5
    assert rcv.reap() == 1              # past it: freed
    assert pool.freed == [0]
    assert rcv.counters["reaped_claimed"] == 1
    # orphaned INSTALL: the router never resumed (it re-routed or died)
    _drive(rcv, "no-resume", META, FRAMES)
    t[0] = 3.0
    assert rcv.reap() == 0              # inside resume_ttl_s: kept
    t[0] = 5.0
    assert rcv.reap() == 1
    assert rcv.counters["reaped_installed"] == 1
    assert rcv.pending() == 0


def test_receiver_restore_undoes_a_failed_take():
    pool = _FakePool()
    rcv = _receiver(pool)
    _drive(rcv, "hk", META, FRAMES)
    slot, meta = rcv.take("hk")
    rcv.restore("hk", slot, meta)       # resume failed before handover
    assert rcv.pending() == 1
    assert rcv.take("hk") == (slot, meta)


# ---------------------------------------------------------------------------
# fast tier: HandoffSender bounded retry against a scripted stub
# ---------------------------------------------------------------------------

class _HandoffStub:
    """Scripted decode-side endpoint: one behavior per connection.

    "ok"          claim, read+verify frames, ack
    "dup"         immediate duplicate ack
    "reject"      refuse the claim
    "frame_error" claim, read frames, report a frame error
    "hang"        claim, then never reply (forces the attempt timeout)
    "eof"         close without replying
    """

    def __init__(self, script=()):
        self.script = list(script)
        self.received = []              # (key, meta, frames) of acked sends
        self._lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._lsock.bind(("127.0.0.1", 0))
        self._lsock.listen(8)
        self.host, self.port = self._lsock.getsockname()[:2]
        self._closing = threading.Event()
        threading.Thread(target=self._accept, daemon=True).start()

    def _accept(self):
        while not self._closing.is_set():
            try:
                conn, _ = self._lsock.accept()
            except OSError:
                return
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _serve(self, conn):
        try:
            with conn:
                op = read_line(conn.makefile("rb"))
                if op is None:
                    return
                beh = self.script.pop(0) if self.script else "ok"
                if beh == "eof":
                    return
                if beh == "dup":
                    send_line(conn, {"acked": True, "key": op["key"],
                                     "dup": True})
                    return
                if beh == "reject":
                    send_line(conn, {"rejected": "pool_exhausted"})
                    return
                send_line(conn, {"claimed": True, "key": op["key"],
                                 "slot": 0})
                stream = conn.makefile("rb")
                try:
                    frames = [read_frame(stream)
                              for _ in range(int(op["frames"]))]
                except (HandoffFrameError, HandoffSizeError) as e:
                    send_line(conn, {"error": str(e),
                                     "etype": type(e).__name__})
                    return
                if beh == "frame_error":
                    send_line(conn, {"error": "scripted",
                                     "etype": "HandoffFrameError"})
                    return
                if beh == "hang":
                    time.sleep(10.0)
                    return
                self.received.append((op["key"], op["meta"], frames))
                send_line(conn, {"acked": True, "key": op["key"],
                                 "dup": False})
        except (OSError, ValueError):
            pass

    def close(self):
        self._closing.set()
        try:
            self._lsock.close()
        except OSError:
            pass


def _sender(**cfg):
    kw = dict(enabled=True, retries=3, backoff_s=0.001, backoff_max_s=0.002,
              attempt_timeout_s=5.0)
    kw.update(cfg)
    return HandoffSender(config=HandoffConfig(**kw))


def test_sender_retries_through_a_frame_error():
    stub = _HandoffStub(["frame_error", "ok"])
    try:
        snd = _sender()
        ack = snd.send(stub.host, stub.port, "hk", META, FRAMES)
        assert ack["acked"] and not ack.get("dup")
        assert stub.received == [("hk", META, FRAMES)]
        assert snd.counters["attempts"] == 2
        assert snd.counters["retries"] == 1
        assert snd.counters["frame_errors"] == 1
    finally:
        stub.close()


def test_sender_exhausts_bounded_budget():
    stub = _HandoffStub(["frame_error"] * 5)
    try:
        snd = _sender(retries=2)
        with pytest.raises(HandoffRetryError) as ei:
            snd.send(stub.host, stub.port, "hk", META, FRAMES)
        assert ei.value.attempts == 2
        assert "refused a frame" in ei.value.last_error
        assert snd.counters["failed"] == 1
        assert snd.counters["attempts"] == 2    # bounded, not forever
    finally:
        stub.close()


def test_sender_duplicate_ack_short_circuits():
    stub = _HandoffStub(["dup"])
    try:
        snd = _sender()
        ack = snd.send(stub.host, stub.port, "hk", META, FRAMES)
        assert ack["dup"]
        assert snd.counters["dup_acked"] == 1
        assert stub.received == []      # nothing re-installed
    finally:
        stub.close()


def test_sender_times_out_a_hung_receiver():
    stub = _HandoffStub(["hang"])
    try:
        snd = _sender(retries=1, attempt_timeout_s=0.2)
        with pytest.raises(HandoffRetryError) as ei:
            snd.send(stub.host, stub.port, "hk", META, FRAMES)
        assert "exceeded" in ei.value.last_error
    finally:
        stub.close()


def test_sender_refuses_oversize_frame():
    stub = _HandoffStub(["ok", "ok"])
    try:
        snd = _sender(retries=2, max_frame_bytes=64)
        with pytest.raises(HandoffRetryError) as ei:
            snd.send(stub.host, stub.port, "hk", META, [b"x" * 100])
        assert "exceeds the 64-byte cap" in ei.value.last_error
        assert stub.received == []
    finally:
        stub.close()


def test_sender_injected_corruption_caught_by_crc_then_retried():
    # the chaos arm flips a payload byte AFTER the crc was computed; the
    # receiver's crc check must refuse the frame and the retry must land
    # the ORIGINAL bytes
    stub = _HandoffStub(["ok", "ok"])
    try:
        injector = ServingFaultInjector().arm_serving(
            "handoff_corrupt_frame", times=1)
        snd = HandoffSender(config=HandoffConfig(enabled=True, retries=3,
                                                 backoff_s=0.001,
                                                 backoff_max_s=0.002),
                            injector=injector)
        ack = snd.send(stub.host, stub.port, "hk", META, FRAMES)
        assert ack["acked"]
        assert snd.counters["frame_errors"] == 1
        assert snd.counters["retries"] == 1
        assert stub.received == [("hk", META, FRAMES)]      # bitwise
    finally:
        stub.close()


# ---------------------------------------------------------------------------
# fast tier: role-aware routing (satellite regressions)
# ---------------------------------------------------------------------------

class RoleStub(StubReplica):
    """StubReplica that advertises a role (optionally hiding it, like a
    pre-roles replica would) and enforces the decode-side submit
    rejection the real replica server applies."""

    def __init__(self, role="mixed", advertise_role=True, **kw):
        self.role = role
        self.advertise_role = advertise_role
        super().__init__(**kw)

    def _serve(self, conn):
        try:
            with conn:
                op = read_line(conn.makefile("rb"))
                if op is None:
                    return
                if op["op"] == "health":
                    doc = {"healthy": True, "draining": self.draining,
                           "queue_depth": self.queue_depth,
                           "active_requests": 0}
                    if self.advertise_role:
                        doc["role"] = self.role
                    send_line(conn, doc)
                    return
                if op["op"] == "degrade":
                    send_line(conn, {"rung": int(op.get("rung", 0))})
                    return
                if (self.role == "decode" and not op.get("force")
                        and not op.get("handoff_key")):
                    send_line(conn, {"rejected": "wrong_role",
                                     "role": self.role})
                    return
                with self.lock:
                    self.submits.append((op["key"], int(op.get("from", 0))))
                toks = self.token_fn(op["prompt"], self.n_tokens)
                for i in range(int(op.get("from", 0)), len(toks)):
                    send_line(conn, {"t": toks[i], "i": i})
                send_line(conn, {"done": True, "n": len(toks)})
        except (OSError, ValueError):
            pass


def _free_port():
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_endpoint_rejects_unknown_role():
    with pytest.raises(ValueError, match="role"):
        ReplicaEndpoint("r0", "127.0.0.1", 1, role="bogus")


def test_health_snapshot_missing_role_defaults_to_mixed(stubs):
    # backward compat: a pre-roles replica whose health doc has no
    # "role" key keeps routing exactly as before
    s = stubs()                         # plain StubReplica: no role key
    r = make_router([s])
    try:
        got = r.submit([1, 2, 3], max_new_tokens=6).result(timeout=5)
        assert got == stub_tokens([1, 2, 3], 6)
        ep = r.endpoints()[0]
        assert ep.role == "mixed"
    finally:
        r.close()


def test_decode_only_fleet_raises_structured_wrong_role_error():
    d = RoleStub(role="decode")
    ep = ReplicaEndpoint("d0", "127.0.0.1", d.port, role="decode")
    r = Router([ep], FleetConfig(enabled=True, **FAST_CFG))
    try:
        fut = r.submit([1, 2, 3], max_new_tokens=4)
        with pytest.raises(WrongRoleError) as ei:
            fut.result(timeout=5)
        assert ei.value.request_kind == "submit"
        assert ei.value.roles == {"d0": "decode"}
        assert d.submits == []          # never reached the replica
    finally:
        r.close()
        d.close()


def test_wrong_role_rejection_teaches_router_the_role():
    # a decode replica the router believes is mixed (stale/absent role in
    # its health doc) rejects the submit with its real role; the router
    # adopts it and re-routes — the request still completes exactly once
    hidden = RoleStub(role="decode", advertise_role=False)
    mixed = RoleStub(role="mixed", queue_depth=5)   # less attractive pick
    eps = [ReplicaEndpoint("hidden", "127.0.0.1", hidden.port),
           ReplicaEndpoint("mixed", "127.0.0.1", mixed.port)]
    # affinity off: least-loaded picks the (queue_depth 0) hidden decode
    # replica first, deterministically
    r = Router(eps, FleetConfig(enabled=True,
                                **{**FAST_CFG, "affinity_prefix_tokens": 0}))
    try:
        got = r.submit([4, 5], max_new_tokens=6).result(timeout=5)
        assert got == stub_tokens([4, 5], 6)
        assert hidden.submits == []     # the decode side served nothing
        assert len(mixed.submits) == 1
        by_name = {ep.name: ep for ep in r.endpoints()}
        assert by_name["hidden"].role == "decode"   # learned from the
    finally:                                        # rejection doc
        r.close()
        hidden.close()
        mixed.close()


def test_handoff_degrades_to_mixed_mode_edge_triggered():
    # phase 1: the only decode endpoint is dead -> requests fall back to
    # interleaved mixed mode, and the degraded instant fires ONCE
    worker = RoleStub(role="mixed")
    dead = ReplicaEndpoint("d-dead", "127.0.0.1", _free_port(),
                           role="decode")
    r = Router([ReplicaEndpoint("m0", "127.0.0.1", worker.port), dead],
               FleetConfig(enabled=True, **FAST_CFG))
    try:
        for prompt in ([1, 2], [3, 4]):
            got = r.submit(prompt, max_new_tokens=6).result(timeout=5)
            assert got == stub_tokens(prompt, 6)
        c = r.counters()
        assert c["handoff_degraded"] == 1       # edge, not per-request
        assert c["handoff_routed"] == 0
        # phase 2: a decode worker comes back -> the handoff path is
        # attempted again and the degraded state clears ...
        alive = RoleStub(role="decode")
        r.remove_endpoint("d-dead")
        r.add_endpoint(ReplicaEndpoint("d0", "127.0.0.1", alive.port,
                                       role="decode"))
        got = r.submit([5, 6], max_new_tokens=6).result(timeout=5)
        assert got == stub_tokens([5, 6], 6)
        assert r.counters()["handoff_routed"] == 1
        # ... so losing it again re-fires the edge exactly once more
        r.remove_endpoint("d0")
        alive.close()
        r.add_endpoint(ReplicaEndpoint("d-dead2", "127.0.0.1",
                                       _free_port(), role="decode"))
        for prompt in ([7, 8], [9, 1]):
            got = r.submit(prompt, max_new_tokens=6).result(timeout=5)
            assert got == stub_tokens(prompt, 6)
        assert r.counters()["handoff_degraded"] == 2
    finally:
        r.close()
        worker.close()


# ---------------------------------------------------------------------------
# fast tier: two role pools, two SLO signals, one autoscaler
# ---------------------------------------------------------------------------

class _RoleHandle:
    def __init__(self, name, role, port):
        self.name = name
        self.role = role
        self.host = "127.0.0.1"
        self.port = port
        self._alive = True

    def alive(self):
        return self._alive

    def endpoint(self):
        return ReplicaEndpoint(self.name, self.host, self.port,
                               role=self.role)


class _RoleSpawner:
    def __init__(self):
        self.roles = []                 # role of every spawn, in order
        self._seq = 0

    def spawn(self, name=None, generation=None, role=None):
        self._seq += 1
        self.roles.append(role)
        return _RoleHandle(name or f"{role}-{self._seq}", role or "mixed",
                           9000 + self._seq)

    def drain(self, handle, wait_s=0.0):
        handle._alive = False
        return True

    def kill(self, handle):
        handle._alive = False


def test_role_pool_autoscaler_scales_pools_on_their_own_signals():
    t = [0.0]
    ttft_firing = [False]
    decode_firing = [False]
    sp = _RoleSpawner()
    hp = _RoleHandle("p0", "prefill", 8001)
    hd = _RoleHandle("d0", "decode", 8002)
    router = Router([hp.endpoint(), hd.endpoint()],
                    FleetConfig(enabled=True, **FAST_CFG))

    def pool_sizes():
        sizes = {"prefill": 0, "decode": 0, "mixed": 0}
        for ep in router.endpoints():
            sizes[ep.role] += 1
        return sizes

    try:
        auto = RolePoolAutoscaler(
            router, sp,
            roles_config=RolesConfig(enabled=True, prefill_replicas=1,
                                     decode_replicas=1,
                                     max_prefill_replicas=3,
                                     max_decode_replicas=3),
            autoscale_config=AutoscaleConfig(enabled=True, warm_spares=0,
                                             up_after_s=1.0,
                                             down_after_s=1000.0,
                                             cooldown_s=0.0),
            ttft_alerts=lambda: ttft_firing[0],
            decode_alerts=lambda: decode_firing[0],
            prefill_replicas=[hp], decode_replicas=[hd],
            clock=lambda: t[0])
        assert auto.step() == {"prefill": None, "decode": None}
        # TTFT over budget grows ONLY the prefill pool
        ttft_firing[0] = True
        auto.step()                     # pressure window opens
        t[0] = 1.0
        assert auto.step()["prefill"] == "up"
        assert sp.roles == ["prefill"]
        assert pool_sizes() == {"prefill": 2, "decode": 1, "mixed": 0}
        # decode tok/s under floor grows ONLY the decode pool
        ttft_firing[0] = False
        decode_firing[0] = True
        t[0] = 1.1
        auto.step()
        t[0] = 2.2
        assert auto.step()["decode"] == "up"
        assert sp.roles == ["prefill", "decode"]
        assert pool_sizes() == {"prefill": 2, "decode": 2, "mixed": 0}
        # only the decode loop owns the fleet-wide degrade rung
        assert auto.prefill.ladder.rung == 0
        stats = auto.stats()
        assert stats["prefill_scale_ups"] == 1.0
        assert stats["decode_scale_ups"] == 1.0
    finally:
        router.close()


# ---------------------------------------------------------------------------
# the export against the JAX pool's, at the same geometry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", ["fp32", "bf16", "int8"])
def test_export_matches_jax_meta_and_frame_lengths(dt):
    """The same lane, installed in both packages' pools (2 layers, 3
    heads, two 4-token pages of a 16-token lane), exports the same meta
    and frames of the same lengths; in fp32 the frames are the same
    bytes."""
    ours = _pool(dt, n_layers=2, n_heads=3)
    theirs = JKVCachePool(n_layers=2, max_slots=2, n_heads=3, max_seq_len=16, head_dim=4,
                          kv_cache_dtype=dt, page_tokens=4)
    k, v = _lane_kv(2, 3)
    slot = ours.allocate(8)
    ours.install(torch.from_numpy(k), torch.from_numpy(v), slot, 6)
    jslot = theirs.allocate(8)
    theirs.install(k, v, jslot, 6)
    meta, frames = ours.export_lane(slot)
    jmeta, jframes = theirs.export_lane(jslot)
    assert meta == jmeta
    assert [len(f) for f in frames] == [len(f) for f in jframes]
    if dt == "fp32":
        assert frames == jframes
    # each package installs the other's frames, and re-exports them as is
    tgt = ours.allocate(8)
    assert ours.install_raw(tgt, jmeta, jframes, handoff_key="from-jax")
    assert ours.export_lane(tgt)[1] == jframes


def test_export_frames_are_copies():
    """Exported frames do not alias the pool: a later write into the
    lane's pages leaves them as they were."""
    pool = _pool()
    slot = _filled_slot(pool)
    meta, frames = pool.export_lane(slot)
    before = [bytes(f) for f in frames]
    pool.k.add_(1.0)
    pool.v.add_(1.0)
    assert frames == before
    assert pool.export_lane(slot)[1] != before


def test_install_raw_refuses_torn_frames():
    src, dst = _pool("int8"), _pool("int8")
    meta, frames = src.export_lane(_filled_slot(src))
    tgt = dst.allocate(8)
    with pytest.raises(PageStateError, match="page frame"):
        dst.install_raw(tgt, meta, [frames[0][:-1]] + frames[1:])
    with pytest.raises(PageStateError, match="scales frame"):
        dst.install_raw(tgt, meta, frames[:-1] + [frames[-1] + b"x"])
    assert dst.handoff_slot(None) is None and dst.positions[tgt] == 0


# ---------------------------------------------------------------------------
# real engines: tiny GPT-2 on the CPU
# ---------------------------------------------------------------------------

TINY = dict(vocab_size=64, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
            max_position_embeddings=32, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)
# the decode kernel's backend for short prompts, the band's for the largest
# bucket, as phase 13 of chip_smoke.py runs them
IMPLS = {"default": "pallas_decode", 16: "pallas_sparse"}
PROMPTS = [[5, 9, 2, 7], [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12], [7]]
N_NEW = 6


@pytest.fixture(scope="module")
def model():
    jcfg = JGPT2Config(**TINY)
    _, params = jinit_gpt2(jcfg, batch_size=2, seq_len=4, seed=0)
    tcfg = GPT2Config(**TINY)
    tmodel = GPT2LMHeadModel.from_jax_params(jax.tree_util.tree_map(np.asarray, params), tcfg)
    return tcfg, tmodel, jcfg, params


def _serving(dt="fp32"):
    return ServingConfig(max_slots=3, max_queue=8, max_seq_len=32, prompt_buckets=(4, 8, 16),
                         kv_page_tokens=4, kv_cache_dtype=dt, attention_impl=IMPLS)


def _engine(model, dt="fp32"):
    tcfg, tmodel = model[0], model[1]
    if dt == "bf16":
        tmodel = GPT2LMHeadModel.from_jax_params(
            jax.tree_util.tree_map(np.asarray, model[3]), tcfg).to(torch.bfloat16)
    return ServingEngine(tmodel, tcfg, _serving(dt), device="cpu")


def _oneshot(eng, prompt, n_new=N_NEW):
    return generate(eng.model, eng.model_config, torch.tensor([prompt]), n_new,
                    attn_impl=eng._impl_for_len(len(prompt)), kv_page_tokens=4,
                    device="cpu")[0].tolist()


def _await(pred, what, timeout_s=30.0):
    deadline = time.monotonic() + timeout_s
    while not pred():
        if time.monotonic() > deadline:
            raise AssertionError(what)
        time.sleep(0.002)


def _await_idle(eng):
    _await(lambda: eng.occupancy()["in_use"] == 0,
           f"KV pages leaked: occupancy {eng.occupancy()}")


@pytest.mark.parametrize("dt", ["fp32", "bf16", "int8"])
def test_engine_handoff_roundtrip_bitwise(model, dt):
    """Prefill on one engine, install the exported pages on another and
    resume: the tokens equal a mixed admission of the same request on the
    decode engine, bit for bit (and in fp32 and bf16 the port's
    ``generate()``); the re-sent install is dropped."""
    src, dst = _engine(model, dt), _engine(model, dt)
    src.start()
    dst.start()
    try:
        for prompt in PROMPTS:
            oracle = list(dst.submit(prompt, max_new_tokens=N_NEW).result(timeout=120))
            if dt != "int8":
                assert oracle == _oneshot(dst, prompt)
            _await_idle(dst)
            req = src.submit_handoff(prompt, reserve_new_tokens=N_NEW)
            first = list(req.future.result(timeout=120))
            assert first == oracle[:1]           # prefill emits exactly token 0
            _await(lambda: getattr(req, "export_payload", None) is not None,
                   "prefill never exported its KV pages")
            meta, frames = req.export_payload
            assert meta["position"] == len(prompt)
            # the whole request span: prompt plus the reserve
            assert meta["pages"] == -(-(len(prompt) + N_NEW) // 4)
            meta = dict(meta, reserve_tokens=len(prompt) + N_NEW)
            slot = dst.handoff_claim(meta["reserve_tokens"])
            key = f"hk-{len(prompt)}"
            assert dst.handoff_install(slot, meta, frames, handoff_key=key) is True
            assert dst.handoff_install(slot, meta, frames, handoff_key=key) is False
            got = list(dst.resume_handoff(slot, prompt, first[0],
                                          max_new_tokens=N_NEW).future.result(timeout=120))
            assert got == oracle
            _await_idle(src)
            _await_idle(dst)
        m = dst.metrics.snapshot()
        assert (m["handoff_installs"], m["handoff_dup_installs"],
                m["handoff_resumes"]) == (3, 3, 3)
        assert src.metrics.snapshot()["handoff_exports"] == 3
    finally:
        src.close()
        dst.close()


def test_handoff_equals_jax_generate(model):
    """The resumed fp32 tokens against the JAX package's ``generate()``
    on the same weights and backends: equal, as the port's serving tests
    hold the two packages' greedy tokens."""
    tcfg, _, jcfg, params = model
    src, dst = _engine(model), _engine(model)
    try:
        for prompt in PROMPTS:
            req = src.submit_handoff(prompt, reserve_new_tokens=N_NEW)
            src.drain(max_steps=50)
            first = req.future.result(timeout=1)
            meta, frames = req.export_payload
            slot = dst.handoff_claim(len(prompt) + N_NEW)
            dst.handoff_install(slot, meta, frames, handoff_key="k")
            fut = dst.resume_handoff(slot, prompt, first[0], max_new_tokens=N_NEW).future
            dst.drain(max_steps=50)
            impl = dst._impl_for_len(len(prompt))
            want = np.asarray(jgenerate(params, jcfg, np.asarray([prompt], np.int32), N_NEW,
                                        attn_impl=impl, kv_page_tokens=4))[0].tolist()
            assert list(fut.result(timeout=1)) == want
    finally:
        src.close()
        dst.close()


def test_submit_handoff_refused_while_draining(model):
    from deepspeed_tpu_torch.inference.serving import EngineDrainingError

    eng = _engine(model)
    try:
        eng.begin_drain()
        assert eng.draining
        with pytest.raises(EngineDrainingError):
            eng.submit_handoff([1, 2, 3], reserve_new_tokens=4)
        with pytest.raises(EngineDrainingError):
            eng.submit([1, 2, 3], max_new_tokens=4)
        with pytest.raises(ValueError, match="reserve_new_tokens"):
            _engine(model).submit_handoff([1, 2, 3], reserve_new_tokens=40)
    finally:
        eng.close()


def test_loop_ops_run_on_the_loop_and_stop_releases_waiters(model):
    """A pool op posted from another thread runs on the serving loop
    (its result or exception comes back); ``stop()`` drains what the loop
    left behind, so no poster waits forever."""
    eng = _engine(model)
    eng.start()
    try:
        seen = []
        assert eng._run_on_loop(lambda: seen.append(threading.current_thread().name) or 7) == 7
        assert seen == ["serving-loop"]
        with pytest.raises(PageStateError):
            eng.handoff_release(0)               # a free slot: double free
    finally:
        eng.stop()
    done = threading.Event()
    box = []
    eng._loop_ops.put((lambda: 3, done, box))
    eng.stop()                                    # no loop: nothing to join
    eng._drain_loop_ops()
    assert done.is_set() and box == [("ok", 3)]
    eng.close()


def test_disagg_socket_end_to_end_bitwise(model):
    """Over real sockets: the router drives prefill on one replica, the
    sender ships the pages to the decode replica, and the resumed stream
    equals ``generate()`` with no page left behind."""
    pre_eng, dec_eng = _engine(model), _engine(model)
    pre = ReplicaServer(pre_eng, role="prefill").start()
    dec = ReplicaServer(dec_eng, role="decode").start()
    r = Router(
        [ReplicaEndpoint("pre", pre.host, pre.port, role="prefill"),
         ReplicaEndpoint("dec", dec.host, dec.port, role="decode")],
        FleetConfig(enabled=True, **{**FAST_CFG, "attempt_timeout_s": 120.0},
                    roles=RolesConfig(enabled=True), handoff=HandoffConfig(enabled=True)))
    try:
        for prompt in PROMPTS:
            oracle = _oneshot(pre_eng, prompt)
            streamed = []
            got = r.submit(prompt, max_new_tokens=N_NEW,
                           stream_cb=lambda k, t: streamed.append(t)).result(timeout=120)
            assert list(got) == oracle
            assert streamed == oracle            # exactly once across the two hops
        c = r.counters()
        assert c["handoff_routed"] == c["handoff_completed"] == len(PROMPTS)
        assert c["handoff_failed"] == 0 and c["handoff_degraded"] == 0
        _await_idle(pre_eng)
        _await_idle(dec_eng)
        assert pre._handoff_receiver.pending() == 0
        assert dec._handoff_receiver.pending() == 0
        assert dec_eng.metrics.snapshot()["handoff_resumes"] == len(PROMPTS)
        # each handoff's bytes and seconds, on both sides
        sent, installed = pre.handoff_stats()["sent"], dec.handoff_stats()["installed"]
        assert len(sent) == len(installed) == len(PROMPTS)
        assert sorted(e["bytes"] for e in sent) == sorted(e["bytes"] for e in installed)
        assert all(e["send_s"] > 0 and e["export_s"] > 0 for e in sent)
        assert all(e["install_s"] > 0 and e["fresh"] for e in installed)
        # a plain submit aimed at the decode replica is refused by role
        with socket.create_connection((dec.host, dec.port), timeout=5.0) as sock:
            send_line(sock, {"op": "submit", "v": 1, "key": "direct",
                             "prompt": PROMPTS[0], "max_new_tokens": 2})
            reply = read_line(sock.makefile("rb"))
        assert reply == {"rejected": "wrong_role", "role": "decode"}
    finally:
        r.close()
        pre.close()
        dec.close()


def test_corrupt_frame_on_the_wire_is_retried_bitwise(model):
    """The ``handoff_corrupt_frame`` arm flips a byte after the crc: the
    receiver refuses the frame, the sender retries under the same key,
    and the resumed tokens still equal ``generate()``."""
    fi = ServingFaultInjector().arm_serving("handoff_corrupt_frame", times=1)
    pre_eng, dec_eng = _engine(model), _engine(model)
    pre = ReplicaServer(pre_eng, role="prefill", injector=fi,
                        handoff_config=HandoffConfig(enabled=True, backoff_s=0.001,
                                                     backoff_max_s=0.002)).start()
    dec = ReplicaServer(dec_eng, role="decode").start()
    r = Router([ReplicaEndpoint("pre", pre.host, pre.port, role="prefill"),
                ReplicaEndpoint("dec", dec.host, dec.port, role="decode")],
               FleetConfig(enabled=True, **{**FAST_CFG, "attempt_timeout_s": 120.0}))
    try:
        prompt = PROMPTS[1]
        got = r.submit(prompt, max_new_tokens=N_NEW).result(timeout=120)
        assert list(got) == _oneshot(pre_eng, prompt)
        assert pre._handoff_sender.counters["frame_errors"] == 1
        assert dec._handoff_receiver.counters["frame_errors"] == 1
        assert dec._handoff_receiver.counters["installs"] == 1
        _await_idle(dec_eng)
    finally:
        r.close()
        pre.close()
        dec.close()


def test_unresumed_install_is_reaped_and_counted(model):
    """An acked handoff the router never resumes is freed by the
    receiver's resume TTL, counted as ``handoff_reaped``."""
    t = [0.0]
    pre_eng, dec_eng = _engine(model), _engine(model)
    dec = ReplicaServer(dec_eng, role="decode",
                        handoff_config=HandoffConfig(enabled=True, resume_ttl_s=5.0))
    dec._handoff_receiver._clock = lambda: t[0]
    dec.start()
    try:
        req = pre_eng.submit_handoff(PROMPTS[0], reserve_new_tokens=N_NEW)
        pre_eng.drain(max_steps=50)
        meta, frames = req.export_payload
        meta = dict(meta, reserve_tokens=len(PROMPTS[0]) + N_NEW)
        ack = HandoffSender(HandoffConfig(enabled=True)).send(
            dec.host, dec.port, "orphan", meta, frames)
        assert ack["acked"] and dec_eng.occupancy()["in_use"] == 1
        t[0] = 6.0
        assert dec._handoff_receiver.reap() == 1
        assert dec_eng.occupancy()["in_use"] == 0
        assert dec_eng.metrics.snapshot()["handoff_reaped"] == 1
    finally:
        dec.close()
        pre_eng.close()


# ---------------------------------------------------------------------------
# slow tier: real prefill/decode replica processes under the chaos arms
# ---------------------------------------------------------------------------

def _disagg_replica_config(tmp_path):
    import json

    from tests.test_torch_fleet_router import MODEL, SERVING

    spec = {"model": MODEL, "seed": 0, "chaos": True, "device": "cpu", "ds_config": {
        "train_batch_size": 1,
        "serving": SERVING,
        "fleet": {"handoff": {
            "attempt_timeout_s": 60.0, "retries": 3, "backoff_s": 0.02,
            "backoff_max_s": 0.2, "claim_ttl_s": 2.0, "resume_ttl_s": 4.0}}}}
    path = tmp_path / "replica.json"
    path.write_text(json.dumps(spec))
    return str(path)


@pytest.mark.slow
@pytest.mark.faults
@pytest.mark.parametrize("kind", ["kill_prefill_mid_handoff", "kill_decode_post_ack"])
def test_disagg_chaos_kill_loses_nothing(tmp_path, kind):
    """Kill the prefill worker mid-transfer / the decode worker right
    after its ack: every affected request still completes exactly once,
    equal to ``generate()``, and no replica is left holding orphaned KV
    pages."""
    import os

    from tests.test_torch_fleet_router import _reference, _tiny_model

    tmodel, tcfg = _tiny_model()
    cache = {}

    def reference(prompt, n):
        key = (tuple(prompt), n)
        if key not in cache:
            cache[key] = _reference(tmodel, tcfg, [list(prompt)], n)[0]
        return cache[key]

    spawner = ProcessReplicaSpawner(_disagg_replica_config(tmp_path),
                                    env=dict(os.environ, OMP_NUM_THREADS="1"))
    router = None
    try:
        replicas = [spawner.spawn("p0", role="prefill"),
                    spawner.spawn("p1", role="prefill"),
                    spawner.spawn("d0", role="decode")]
        router = Router([h.endpoint() for h in replicas],
                        FleetConfig(enabled=True, retry_budget=4, retry_backoff_s=0.05,
                                    attempt_timeout_s=300.0, health_ttl_s=0.1,
                                    affinity_prefix_tokens=0))
        warm = [2, 3, 5, 7]
        out = router.submit(warm, max_new_tokens=6).result(timeout=600)
        assert list(out) == reference(warm, 6)
        assert router.counters()["handoff_completed"] >= 1
        harness = DisaggChaosHarness(
            router, spawner, reference, replicas, seed=11, max_new_tokens=6,
            request_timeout_s=300.0, recovery_timeout_s=300.0, vocab=60)
        record = harness.run_episode(kind=kind)
        assert record["bitwise_mismatch"] == 0
        assert record["stuck"] == 0
        assert record["recovered"]
        assert record["pages_clean"]
        report = harness.report()
        assert report["invariant_pages_clean"]
        assert report["disagg_episodes"] == 1
    finally:
        if router is not None:
            router.close()
        spawner.stop_all()
