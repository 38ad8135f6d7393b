"""One serving-fleet replica: a ServingEngine behind a line-JSON socket.

A copy of ``deepspeed_tpu/inference/serving/replica.py`` with the imports
and the engine build rebound: the replica builds this package's GPT-2
(``build_model``) on ``spec["device"]`` (default ``"cuda"``; a replica
that finds no card raises and exits non-zero) and this package's
``ServingEngine``. The wire protocol is the JAX package's.

The worker half of the fleet tier (router.py is the front-door). A
replica wraps ONE :class:`ServingEngine` in a TCP server speaking the
router's line-delimited JSON protocol, and owns the per-replica halves
of the robustness story:

- **idempotent submission**: requests are keyed by the router's
  idempotency key. A re-submitted key (the router re-routing after a
  wobble, or re-attaching after its own socket died) does NOT create a
  second generation — it attaches to the existing :class:`_Flight` and
  replays tokens from the requested ``from`` index. Greedy decoding is
  deterministic, so a DIFFERENT replica recomputing the same key yields
  the same bits; the ``from`` replay just skips what the router already
  delivered.
- **graceful drain**: SIGTERM (the supervisor's polite recycle, the
  ``PreemptionHandler`` signal contract) flips the engine's draining
  flag — new keys are rejected with ``{"rejected": "draining"}`` so the
  router re-routes them, while accepted work keeps decoding to
  completion (retries of ACCEPTED keys still attach, draining or not).
  When ``engine.pending()`` hits zero (or ``drain_timeout_s`` passes)
  the process exits ``EXIT_PREEMPTED`` so the supervisor restarts it
  without backoff.
- **fault arms**: the engine's :class:`ServingFaultInjector` fleet arms
  act here — ``kill_replica`` fires inside the decode step (hard
  death), ``slow_replica`` delays every socket reply, and
  ``reject_admission`` bounces submissions before they reach the
  engine.
- **health**: ``{"op": "health"}`` on the socket answers the same facts
  the telemetry ``/healthz`` endpoint serves (queue depth, active
  lanes, draining, loop liveness) plus ``process_cpu_s`` and
  ``tokens_total`` so the fleet bench can compute CPU-time-normalized
  throughput on core-starved machines. When the engine has a telemetry
  server (``DSTPU_TELEMETRY_PORT``), a "replica" provider is registered
  there too.

``replica_main()`` is the supervised worker entry point: it reads
``DSTPU_REPLICA_PORT`` / ``DSTPU_REPLICA_CONFIG``, builds a
deterministic model (``build_model``: every replica holds bit-identical
parameters, whose SHA-256 its health doc carries as ``params_sha256``
once a thread has computed it),
serves until SIGTERM, drains, and exits by the supervisor's exit-code
contract.
"""

import argparse
import hashlib
import json
import os
import queue
import signal
import socket
import sys
import threading
import time
from collections import OrderedDict, deque

import torch

from deepspeed_tpu_torch.inference.serving.handoff import (
    HandoffError,
    HandoffReceiver,
    HandoffSender,
)
from deepspeed_tpu_torch.inference.serving.scheduler import (
    EngineDrainingError,
    QueueFullError,
    RequestTimeoutError,
)
from deepspeed_tpu_torch.inference.serving.router import (
    PROTOCOL_VERSION,
    REPLICA_ROLES,
    read_line,
    send_line,
)

from deepspeed_tpu_torch.models.gpt2 import GPT2Config, init_gpt2, resolve_device

REPLICA_PORT_ENV = "DSTPU_REPLICA_PORT"
REPLICA_CONFIG_ENV = "DSTPU_REPLICA_CONFIG"

_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16, "fp16": torch.float16}

# completed flights kept for duplicate-submit replay before eviction
_FLIGHT_CACHE = 1024


class _Flight:
    """Idempotency record for one keyed request.

    Tokens fan out to every attached connection queue as the engine
    emits them; late attachments replay the prefix they ask for. The
    flight outlives its connections — a router whose socket died
    re-attaches by key and loses nothing."""

    def __init__(self, key):
        self.key = key
        self.lock = threading.Lock()
        self.tokens = []
        self.done = False
        self.error = None               # terminal error doc, or None
        self._queues = []

    def attach(self, start):
        """Subscribe from token index ``start``; returns a Queue of
        ("t", i, token) frames followed by one ("end",) frame."""
        q = queue.Queue()
        with self.lock:
            for i in range(max(0, int(start)), len(self.tokens)):
                q.put(("t", i, self.tokens[i]))
            if self.done:
                q.put(("end",))
            else:
                self._queues.append(q)
        return q

    def emit(self, token):
        with self.lock:
            i = len(self.tokens)
            self.tokens.append(int(token))
            for q in self._queues:
                q.put(("t", i, token))

    def finish(self, error_doc=None):
        with self.lock:
            self.done = True
            self.error = error_doc
            for q in self._queues:
                q.put(("end",))
            self._queues = []


def _error_doc(exc):
    doc = {"error": str(exc), "etype": type(exc).__name__}
    if isinstance(exc, RequestTimeoutError):
        doc["detail"] = {
            "request_id": exc.request_id, "timeout_s": exc.timeout_s,
            "phase": exc.phase, "tokens_done": exc.tokens_done}
    return doc


class ReplicaServer:
    """Line-JSON socket front on one ServingEngine (one op/connection)."""

    def __init__(self, engine, host="127.0.0.1", port=0, injector=None,
                 drain_timeout_s=30.0, role="mixed", handoff_config=None):
        role = str(role or "mixed")
        if role not in REPLICA_ROLES:
            raise ValueError(
                f"role must be one of {REPLICA_ROLES}, got {role!r}")
        self.engine = engine
        self.injector = injector if injector is not None else engine.injector
        self.drain_timeout_s = float(drain_timeout_s)
        self.role = role
        # handoff plumbing is always built (it is cheap and stateless
        # until used): a mixed replica may be the decode target of a
        # prefill worker, and a prefill worker only sends
        self._handoff_sender = HandoffSender(
            config=handoff_config, injector=self.injector)
        self._handoff_receiver = HandoffReceiver(
            handoff_config,
            allocate_fn=engine.handoff_claim,
            install_fn=self._timed_install,
            free_fn=engine.handoff_release,
            on_event=self._handoff_event)
        # the newest handoffs this replica sent and installed, with their
        # bytes and seconds (the telemetry "handoff" snapshot)
        self._handoff_log = {"sent": deque(maxlen=256),
                             "installed": deque(maxlen=256)}
        self._handoff_log_lock = threading.Lock()
        self._flights = OrderedDict()       # key -> _Flight
        self._flights_lock = threading.Lock()
        self._tokens_total = 0
        self._active_conns = 0              # submit handlers mid-stream
        self._accept_thread = None
        self._closing = threading.Event()
        self._lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._lsock.bind((host, int(port)))
        self._lsock.listen(64)
        self.host, self.port = self._lsock.getsockname()[:2]
        if engine.telemetry_server is not None:
            engine.telemetry_server.add_health_provider(
                "replica", self._replica_health)
            engine.telemetry_server.add_snapshot_provider(
                "handoff", self.handoff_stats)

    # -- lifecycle -------------------------------------------------------
    def start(self, idle_sleep_s=0.001):
        self.engine.start(idle_sleep_s=idle_sleep_s)
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="replica-accept", daemon=True)
        self._accept_thread.start()
        return self

    def begin_drain(self):
        """Stop admitting NEW keys (engine raises EngineDrainingError and
        the socket answers ``rejected: draining``); accepted work keeps
        decoding. The SIGTERM half of the drain sequence."""
        self.engine.begin_drain()

    def drain_and_stop(self):
        """Block until in-flight work finishes (or drain_timeout_s),
        then stop the loop. True = drained clean, False = timed out."""
        self.begin_drain()
        deadline = time.monotonic() + self.drain_timeout_s
        while self.engine.pending() > 0 and time.monotonic() < deadline:
            time.sleep(0.005)
        clean = self.engine.pending() == 0
        # let in-stream connections flush their terminal frames: exiting
        # with a done-but-unsent frame would turn a clean drain into a
        # router-visible EOF (a pointless failure retry)
        while self._active_conns > 0 and time.monotonic() < deadline:
            time.sleep(0.005)
        self.engine.stop()
        return clean

    def close(self):
        self._closing.set()
        try:
            # shutdown first: close() alone doesn't wake a thread blocked
            # in accept(), and the kernel socket would keep accepting
            self._lsock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._lsock.close()
        except OSError:
            pass
        if self._accept_thread is not None:
            self._accept_thread.join(2.0)
            self._accept_thread = None
        self.engine.close()

    # -- health ----------------------------------------------------------
    def _replica_health(self):
        eng = self.engine
        # the health probe doubles as the orphan reaper's heartbeat:
        # the router probes every replica on a TTL, so expired handoff
        # claims are freed even on an otherwise-idle decode worker
        self._handoff_receiver.reap()
        with self._flights_lock:
            flights = len(self._flights)
        doc = dict(eng._loop_health())
        doc.update({
            "port": self.port,
            "role": self.role,
            "flights": flights,
            "tokens_total": self._tokens_total,
            "process_cpu_s": time.process_time(),
            "pid": os.getpid(),
            # the chaos harness's zero-leak invariant reads these
            "kv_pool": eng.occupancy(),
            "handoff_pending": self._handoff_receiver.pending(),
            # the affinity test's evidence: hits survive scale-out
            "prefix_cache": eng.prefix_stats(),
            "params_sha256": getattr(eng, "params_sha256", None),
            # spill tier + memory-pressure guard (memtier chaos reads it)
            "memtier": eng.memtier_stats()})
        return doc

    def handoff_stats(self):
        """Sender and receiver counters, and the newest handoffs each way:
        key, bytes, and the export, send or install seconds."""
        with self._handoff_log_lock:
            sent = list(self._handoff_log["sent"])
            installed = list(self._handoff_log["installed"])
        return {"sender": dict(self._handoff_sender.counters),
                "receiver": dict(self._handoff_receiver.counters),
                "sent": sent, "installed": installed}

    def _log_handoff(self, side, entry):
        with self._handoff_log_lock:
            self._handoff_log[side].append(entry)

    def _timed_install(self, slot, meta, frames, key):
        t0 = time.monotonic()
        fresh = self.engine.handoff_install(slot, meta, frames, key)
        self._log_handoff("installed", {
            "key": key, "bytes": sum(len(f) for f in frames),
            "pages": int(meta.get("pages", len(frames))), "fresh": bool(fresh),
            "install_s": time.monotonic() - t0})
        return fresh

    def _handoff_event(self, name):
        if name == "reaped":
            self.engine.metrics.record_handoff("reaped")

    # -- socket plumbing -------------------------------------------------
    def _accept_loop(self):
        while not self._closing.is_set():
            try:
                conn, _ = self._lsock.accept()
            except OSError:
                return                  # listener closed
            threading.Thread(target=self._serve_conn, args=(conn,),
                             name="replica-conn", daemon=True).start()

    def _reply(self, conn, doc):
        """Send one frame, honoring the slow_replica arm's delay."""
        if self.injector is not None:
            delay = self.injector.reply_delay_s()
            if delay > 0:
                time.sleep(delay)
        send_line(conn, doc)

    def _serve_conn(self, conn):
        try:
            with conn:
                conn.settimeout(30.0)
                # ONE buffered stream per connection: the handoff op's
                # binary page frames follow the claim line on the same
                # socket, so bytes the line reader buffered must stay
                # readable (a second makefile would lose them)
                stream = conn.makefile("rb")
                op = read_line(stream)
                if op is None:
                    return
                kind = op.get("op")
                if kind == "submit":
                    self._active_conns += 1
                    try:
                        self._handle_submit(conn, op)
                    finally:
                        self._active_conns -= 1
                elif kind == "handoff":
                    self._handoff_receiver.handle(
                        conn, stream, op, self._handoff_reply)
                elif kind == "health":
                    self._reply(conn, self._replica_health())
                elif kind == "drain":
                    self.begin_drain()
                    self._reply(conn, {"draining": True,
                                       "pending": self.engine.pending()})
                elif kind == "degrade":
                    rung = self.engine.set_degrade_rung(
                        int(op.get("rung", 0)),
                        reason=str(op.get("reason", "fleet")))
                    self._reply(conn, {"rung": rung})
                elif kind == "inject":
                    self._handle_inject(conn, op)
                else:
                    self._reply(conn, {"error": f"unknown op {kind!r}",
                                       "etype": "ValueError"})
        except (OSError, ValueError):
            pass                        # peer went away mid-reply

    def _handoff_reply(self, conn, doc):
        """Handoff-op replies, plus the kill-decode-post-ack arm: the
        injected death fires AFTER the ack hit the wire — the prefill
        side believes the transfer landed, then the resume target
        disappears."""
        self._reply(conn, doc)
        if doc.get("acked") and self.injector is not None:
            self.injector.maybe_kill_post_ack()

    # -- the inject op (the chaos harness's remote arm) ------------------
    def _handle_inject(self, conn, op):
        """Arm/disarm a serving fault point over the socket so the chaos
        harness can slow/reject/kill a LIVE replica without reaching into
        its process. ``{"op": "inject", "point": null}`` disarms all;
        any other keys ride through as arm kwargs."""
        if self.injector is None:
            self._reply(conn, {"error": "replica built without injector",
                               "etype": "RuntimeError"})
            return
        point = op.get("point")
        try:
            if point is None or point == "disarm":
                self.injector.disarm_serving(op.get("only"))
                self._reply(conn, {"disarmed": True})
                return
            kwargs = {k: v for k, v in op.items() if k not in ("op", "point")}
            self.injector.arm_serving(str(point), **kwargs)
            self._reply(conn, {"armed": str(point)})
        except (ValueError, TypeError) as e:
            self._reply(conn, _error_doc(e))

    # -- the submit op ---------------------------------------------------
    def _handle_submit(self, conn, op):
        key = str(op.get("key", ""))
        start = int(op.get("from", 0))
        if not key:
            self._reply(conn, {"error": "submit without key",
                               "etype": "ValueError"})
            return
        if op.get("handoff_key"):
            self._handle_resume(conn, op)
            return
        if op.get("handoff"):
            self._handle_submit_handoff(conn, op)
            return
        if self.role == "decode" and not op.get("force"):
            # role is a scheduling policy, not a capability: the router
            # learns/refreshes this endpoint's role from the rejection
            # and re-picks; a deliberate degraded-mode route carries
            # "force" and is served. Retries of accepted keys attach.
            with self._flights_lock:
                accepted = key in self._flights
            if not accepted:
                self._reply(conn, {"rejected": "wrong_role",
                                   "role": self.role})
                return
        flight, created = self._flight_for(key, op, conn)
        if flight is None:
            return                      # rejection/error already sent
        self._stream_flight(conn, flight, start)

    def _stream_flight(self, conn, flight, start):
        """Drain a flight's frames to the connection: tokens, then ONE
        terminal doc — the flight's error/terminal doc if set (a timeout
        doc, a ``handoff_done``/``handoff_failed`` verdict), else plain
        ``done``."""
        q = flight.attach(start)
        while True:
            frame = q.get()
            if frame[0] == "end":
                if flight.error is not None:
                    self._reply(conn, flight.error)
                else:
                    self._reply(conn, {"done": True,
                                       "n": len(flight.tokens)})
                return
            _, i, token = frame
            self._reply(conn, {"t": token, "i": i})

    # -- disaggregated handoff: hop 1 (prefill side) ---------------------
    def _handle_submit_handoff(self, conn, op):
        """Prefill-only submit: run prefill, stream the first token the
        moment it exists (TTFT ends BEFORE any page transfer), then ship
        the exported pages to the decode worker named in
        ``op["handoff"]`` and reply ``handoff_done`` (the router's cue
        to resume on the decode side) or ``handoff_failed`` (its cue to
        fall back to a plain route). Flights are keyed by the
        per-attempt handoff key, NEVER the request key — a 1-token
        hop-1 flight must not satisfy a later full re-route."""
        ho = dict(op.get("handoff") or {})
        hkey = str(ho.get("key") or "")
        if not hkey or not ho.get("host") or not ho.get("port"):
            self._reply(conn, {"error": "handoff without host/port/key",
                               "etype": "ValueError"})
            return
        fkey = "ho1:" + hkey
        with self._flights_lock:
            flight = self._flights.get(fkey)
        if flight is None:
            if self.injector is not None \
                    and self.injector.admission_rejected():
                self._reply(conn, {"rejected": "injected"})
                return
            flight = _Flight(fkey)
            try:
                req = self.engine.submit_handoff(
                    op.get("prompt") or [],
                    reserve_new_tokens=int(op.get("max_new_tokens") or 1),
                    eos_token_id=op.get("eos_token_id"),
                    timeout_s=op.get("timeout_s"),
                    stream_cb=lambda _rid, tok: self._emit(flight, tok),
                    age_s=float(op.get("age_s", 0.0)))
            except EngineDrainingError:
                self._reply(conn, {"rejected": "draining"})
                return
            except QueueFullError:
                self._reply(conn, {"rejected": "queue_full"})
                return
            except (ValueError, TypeError) as e:
                self._reply(conn, _error_doc(e))
                return
            self._register_flight(fkey, flight)
            threading.Thread(
                target=self._await_handoff, args=(flight, req, ho, op),
                name=f"handoff-{hkey[:8]}", daemon=True).start()
        self._stream_flight(conn, flight, int(op.get("from", 0)))

    def _await_handoff(self, flight, req, ho, op):
        """Hop-1 completion driver: wait for the prefill-only request to
        retire, then run the claim→transfer→ack protocol against the
        decode worker and publish the verdict as the flight's terminal
        doc."""
        try:
            tokens = req.future.result()
        except Exception as e:          # timeout/terminal: plain error
            flight.finish(_error_doc(e))
            return
        first = int(tokens[0])
        eos = op.get("eos_token_id")
        max_new = int(op.get("max_new_tokens") or 1)
        if max_new <= 1 or (eos is not None and first == int(eos)):
            flight.finish()             # complete at its first token
            return
        payload = getattr(req, "export_payload", None)
        if payload is None:
            exc = getattr(req, "export_error", None)
            flight.finish({"handoff_failed": True, "key": ho.get("key"),
                           "etype": "HandoffError",
                           "error": f"lane export missing: {exc}",
                           "n": len(flight.tokens)})
            return
        meta, frames = payload
        meta = dict(meta)
        prompt = op.get("prompt") or []
        meta["reserve_tokens"] = min(len(prompt) + max_new,
                                     self.engine.max_seq_len)
        meta["first_token"] = first
        meta["prompt_len"] = len(prompt)
        t0 = time.monotonic()
        try:
            self._handoff_sender.send(
                str(ho["host"]), int(ho["port"]), str(ho["key"]),
                meta, frames)
            self._log_handoff("sent", {
                "key": str(ho["key"]), "bytes": sum(len(f) for f in frames),
                "pages": int(meta.get("pages", len(frames))),
                "prompt_len": len(prompt),
                "export_s": getattr(req, "export_s", None),
                "send_s": time.monotonic() - t0})
        except (HandoffError, OSError) as e:
            flight.finish({"handoff_failed": True, "key": ho.get("key"),
                           "etype": type(e).__name__, "error": str(e),
                           "n": len(flight.tokens)})
            return
        flight.finish({"handoff_done": True, "key": ho.get("key"),
                       "n": len(flight.tokens)})

    # -- disaggregated handoff: hop 2 (decode side) ----------------------
    def _handle_resume(self, conn, op):
        """Resume a request whose pages an earlier handoff installed:
        take the installed claim, activate the lane, and stream tokens
        from index 1 (index 0 — the first token — was delivered by the
        prefill worker; the flight is pre-seeded with it so the done
        count covers the whole generation)."""
        hkey = str(op.get("handoff_key"))
        fkey = "ho2:" + hkey
        with self._flights_lock:
            flight = self._flights.get(fkey)
        if flight is None:
            taken = self._handoff_receiver.take(hkey)
            if taken is None:
                # unknown/unfinished/reaped claim: the router re-routes
                # the whole request as a plain submit, losing nothing
                self._reply(conn, {"rejected": "handoff_unknown"})
                return
            slot, meta = taken
            flight = _Flight(fkey)
            first = int(meta.get("first_token",
                                 op.get("first_token", 0)))
            flight.tokens = [first]     # index 0, delivered by hop 1
            try:
                req = self.engine.resume_handoff(
                    slot, op.get("prompt") or [], first,
                    max_new_tokens=op.get("max_new_tokens"),
                    eos_token_id=op.get("eos_token_id"),
                    timeout_s=op.get("timeout_s"),
                    stream_cb=lambda _rid, tok: self._emit(flight, tok),
                    age_s=float(op.get("age_s", 0.0)))
            except Exception as e:      # resume failed pre-activation:
                self._handoff_receiver.restore(hkey, slot, meta)
                self._reply(conn, _error_doc(e))
                return
            self._register_flight(fkey, flight)
            threading.Thread(target=self._await, args=(flight, req.future),
                             name=f"resume-{hkey[:8]}", daemon=True).start()
        self._stream_flight(conn, flight, int(op.get("from", 1)))

    def _register_flight(self, key, flight):
        with self._flights_lock:
            self._flights[key] = flight
            while len(self._flights) > _FLIGHT_CACHE:
                old_key, old = next(iter(self._flights.items()))
                if not old.done:
                    break               # never evict live work
                self._flights.pop(old_key)

    def _flight_for(self, key, op, conn):
        """Existing flight for ``key``, or a freshly-submitted one.
        Returns (flight, created); (None, False) after replying with a
        rejection/terminal error. Injected/draining rejections apply
        only to NEW keys: a retry of accepted work always attaches."""
        with self._flights_lock:
            flight = self._flights.get(key)
            if flight is not None:
                self._flights.move_to_end(key)
                return flight, False
        if self.injector is not None and self.injector.admission_rejected():
            self._reply(conn, {"rejected": "injected"})
            return None, False
        flight = _Flight(key)
        try:
            future = self.engine.submit(
                op.get("prompt") or [],
                max_new_tokens=op.get("max_new_tokens"),
                eos_token_id=op.get("eos_token_id"),
                timeout_s=op.get("timeout_s"),
                stream_cb=lambda _rid, tok: self._emit(flight, tok),
                age_s=float(op.get("age_s", 0.0)))
        except EngineDrainingError:
            self._reply(conn, {"rejected": "draining"})
            return None, False
        except QueueFullError:
            self._reply(conn, {"rejected": "queue_full"})
            return None, False
        except (ValueError, TypeError) as e:
            self._reply(conn, _error_doc(e))
            return None, False
        # registering after engine.submit is race-free: the router runs
        # one attempt per request at a time, so no concurrent FIRST
        # submit for this key exists; tokens can't be missed because
        # emission goes through the flight from token zero.
        self._register_flight(key, flight)
        threading.Thread(target=self._await, args=(flight, future),
                         name=f"flight-{key[:8]}", daemon=True).start()
        return flight, True

    def _emit(self, flight, token):
        self._tokens_total += 1
        flight.emit(token)

    def _await(self, flight, future):
        try:
            future.result()
        except Exception as e:          # terminal verdict rides the doc
            flight.finish(_error_doc(e))
            return
        flight.finish()


def build_model(spec, device="cuda"):
    """The replica's GPT-2 from a replica-config spec: random weights
    drawn from ``spec["seed"]`` on a CPU generator, then moved to
    ``device``, so every replica built from one spec, on any card, holds
    bit-identical parameters (what makes a cross-replica retry bitwise).
    ``spec["dtype"]`` ("fp32", "bf16" or "fp16") casts them. Returns
    ``(model, config)``."""
    model = dict(spec.get("model") or {})
    model.setdefault("hidden_dropout_prob", 0.0)
    model.setdefault("attention_probs_dropout_prob", 0.0)
    cfg = GPT2Config(**model)
    device = resolve_device(device)          # raises without a card
    dtype = _DTYPES[str(spec.get("dtype", "fp32"))]
    net = init_gpt2(cfg, seed=int(spec.get("seed", 0)), device="cpu")
    return net.to(device=device, dtype=dtype), cfg


def params_sha256(model):
    """SHA-256 over every parameter's bytes, in ``named_parameters``
    order: two replicas built from one spec must agree."""
    h = hashlib.sha256()
    for name, p in model.named_parameters():
        h.update(name.encode())
        h.update(p.detach().to("cpu").contiguous().view(torch.uint8).numpy())
    return h.hexdigest()


def _build_engine(spec):
    """Deterministic engine from a replica-config spec on
    ``spec["device"]`` (default ``"cuda"``)."""
    from deepspeed_tpu_torch.inference.serving.engine import ServingEngine

    device = spec.get("device", "cuda")
    model, cfg = build_model(spec, device=device)
    injector = None
    if spec.get("chaos"):
        # chaos-harness replicas carry an (unarmed) injector so the
        # "inject" socket op can arm fault points at runtime; normal
        # fleet replicas stay injector-free (an injector claims full
        # lanes in _alloc_tokens, which changes packing behavior)
        from deepspeed_tpu_torch.inference.serving.fault_injection import (
            ServingFaultInjector,
        )
        injector = ServingFaultInjector()
    eng = ServingEngine.from_config(
        model, cfg, dict(spec.get("ds_config") or {}),
        rank=int(os.environ.get("RANK", "0")), injector=injector, device=device)
    # hashed off the start-up path (GPT-2 XL's 6 GB take seconds): the
    # health doc carries None until the thread is done
    eng.params_sha256 = None
    threading.Thread(target=lambda: setattr(eng, "params_sha256", params_sha256(model)),
                     name="params-sha256", daemon=True).start()
    return eng


def replica_main(argv=None):
    """Supervised fleet-worker entry point.

    Config comes from ``--config`` / ``DSTPU_REPLICA_CONFIG`` (a JSON
    file: ``{"model": {...GPT2Config kwargs...}, "seed": 0,
    "ds_config": {...}}``); the serving port from ``--port`` /
    ``DSTPU_REPLICA_PORT``. Prints one ``{"ready": true, "port": N}``
    line to stdout once listening (the launcher/bench reads it), then
    serves until SIGTERM -> drain -> ``EXIT_PREEMPTED``."""
    from deepspeed_tpu_torch.launcher.supervisor import EXIT_CLEAN, EXIT_PREEMPTED

    parser = argparse.ArgumentParser(description="serving-fleet replica")
    parser.add_argument("--config",
                        default=os.environ.get(REPLICA_CONFIG_ENV))
    parser.add_argument(
        "--port", type=int,
        default=int(os.environ.get(REPLICA_PORT_ENV, "0")))
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument(
        "--role", default=None, choices=list(REPLICA_ROLES),
        help="disaggregated-serving role (default: spec['role'] or mixed)")
    args = parser.parse_args(argv)
    if not args.config:
        parser.error(f"--config or {REPLICA_CONFIG_ENV} is required")
    with open(args.config) as f:
        spec = json.load(f)

    engine = _build_engine(spec)
    fleet = dict(spec.get("ds_config", {}).get("fleet") or {})
    handoff_config = None
    if fleet.get("handoff") is not None:
        from deepspeed_tpu_torch.runtime.config import _get_fleet_handoff
        handoff_config = _get_fleet_handoff(fleet)
    server = ReplicaServer(
        engine, host=args.host, port=args.port,
        drain_timeout_s=float(fleet.get("drain_timeout_s", 30.0)),
        role=args.role or spec.get("role") or "mixed",
        handoff_config=handoff_config)

    # PreemptionHandler's signal discipline, serving-shaped: the handler
    # only flips a flag; the main thread notices and drains. check() is
    # the TRAINING drain (checkpoint + exit) so the replica runs its own.
    term = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: term.set())
    signal.signal(signal.SIGINT, lambda *_: term.set())

    server.start()
    print(json.dumps({"ready": True, "port": server.port,
                      "pid": os.getpid(), "role": server.role,
                      "v": PROTOCOL_VERSION}),
          flush=True)
    try:
        while not term.is_set():
            term.wait(0.1)
        drained = server.drain_and_stop()
        print(json.dumps({"drained": bool(drained)}), flush=True)
        return EXIT_PREEMPTED
    finally:
        server.close()
    return EXIT_CLEAN


if __name__ == "__main__":
    sys.exit(replica_main())
