"""The port's fleet router and replicas: failover, draining, shedding,
affinity.

Three tiers. The first is the JAX package's ``tests/unit/test_router.py``
fast tier on the port's copies: the Router against in-process stub
replicas speaking the wire protocol (routing policy, exactly-once retry
accounting, rejection and drain handling, admission control, affinity,
gauges), the scheduler's backdated timestamps and the injector's fleet
arms. A stub that has rejected a request as draining advertises
draining in its health doc from then on, as a draining replica does, so
the draining test does not race the health probe's TTL. The second drives real engines (tiny GPT-2
on the CPU) behind in-process ``ReplicaServer``s on localhost: a replica
that dies mid-decode (its ``kill_replica`` arm shuts its sockets and
ends its loop) loses no accepted request and each output equals the
port's ``generate()`` with no token streamed twice; a drained replica
finishes its in-flight request while new requests go to the other. The
third (``slow``, as the JAX package marks its own) spawns real replica
processes, ``python -m deepspeed_tpu_torch.inference.serving.replica``:
one SIGKILLed by its arm, one drained by SIGTERM to exit
``EXIT_PREEMPTED``.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import pytest

from deepspeed_tpu_torch.inference.serving.config import FleetConfig
from deepspeed_tpu_torch.inference.serving.fault_injection import (
    ServingFaultInjector,
)
from deepspeed_tpu_torch.inference.serving.router import (
    FleetOverloadError,
    ReplicaEndpoint,
    RequestPoisonedError,
    Router,
    read_line,
    send_line,
)
from deepspeed_tpu_torch.inference.serving.scheduler import (
    ContinuousBatchingScheduler,
    Request,
    RequestTimeoutError,
)

FAST_CFG = dict(retry_budget=2, retry_backoff_s=0.005,
                retry_backoff_max_s=0.02, attempt_timeout_s=5.0,
                health_ttl_s=0.02, shed_retry_after_s=0.25)


# ---------------------------------------------------------------------------
# stub replica: the wire protocol without an engine
# ---------------------------------------------------------------------------

def stub_tokens(prompt, n):
    """Deterministic 'generation' any stub can recompute — the stand-in
    for greedy decoding being a pure function of the prompt."""
    return [(sum(prompt) * 31 + i * 7) % 1000 for i in range(n)]


class StubReplica:
    """In-process protocol server with scriptable behavior."""

    def __init__(self, die_after=None, reject=None, reject_times=10 ** 9,
                 queue_depth=0, draining=False, reply_delay_s=0.0,
                 n_tokens=6, token_fn=None, close_on_die=False):
        self.die_after = die_after      # close socket after N token frames
        self.close_on_die = close_on_die    # ... and stop listening for good
        self.reject = reject            # "queue_full"|"draining"|"injected"
        self.reject_times = reject_times
        self.queue_depth = queue_depth
        self.draining = draining
        self.reply_delay_s = reply_delay_s
        self.n_tokens = n_tokens
        # overridable "weights": rollout tests give stubs per-generation
        # token functions so shadow diffing has something to diff
        self.token_fn = token_fn or stub_tokens
        self.submits = []               # (key, from) observed
        self.lock = threading.Lock()
        self._ls = socket.socket()
        self._ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._ls.bind(("127.0.0.1", 0))
        self._ls.listen(16)
        self.port = self._ls.getsockname()[1]
        self._closing = False
        threading.Thread(target=self._accept, daemon=True).start()

    def endpoint(self, name):
        return ReplicaEndpoint(name, "127.0.0.1", self.port)

    def close(self):
        self._closing = True
        try:
            # close() alone doesn't wake a thread blocked in accept();
            # the kernel socket would keep accepting connections
            self._ls.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._ls.close()
        except OSError:
            pass

    def _accept(self):
        while not self._closing:
            try:
                conn, _ = self._ls.accept()
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
                if self.reply_delay_s:
                    time.sleep(self.reply_delay_s)
                if op["op"] == "health":
                    send_line(conn, {
                        "healthy": True, "draining": self.draining,
                        "queue_depth": self.queue_depth,
                        "active_requests": 0})
                    return
                if op["op"] == "degrade":   # fleet rung fan-out: just ack
                    send_line(conn, {"rung": int(op.get("rung", 0))})
                    return
                with self.lock:
                    self.submits.append((op["key"], int(op.get("from", 0))))
                    if self.reject is not None and self.reject_times > 0:
                        self.reject_times -= 1
                        # a replica that rejects as draining is draining:
                        # its health says so from now on
                        self.draining = self.draining or self.reject == "draining"
                        send_line(conn, {"rejected": self.reject})
                        return
                toks = self.token_fn(op["prompt"], self.n_tokens)
                sent = 0
                for i in range(int(op.get("from", 0)), len(toks)):
                    if self.die_after is not None and sent >= self.die_after:
                        if self.close_on_die:
                            self.close()
                        return          # socket EOF mid-stream
                    send_line(conn, {"t": toks[i], "i": i})
                    sent += 1
                if self.die_after is not None and sent >= self.die_after:
                    return
                send_line(conn, {"done": True, "n": len(toks)})
        except (OSError, ValueError):
            pass


@pytest.fixture
def stubs(request):
    made = []

    def make(**kw):
        s = StubReplica(**kw)
        made.append(s)
        return s

    yield make
    for s in made:
        s.close()


def make_router(replicas, **over):
    cfg = FleetConfig(enabled=True, **{**FAST_CFG, **over})
    eps = [s.endpoint(f"r{i}") for i, s in enumerate(replicas)]
    return Router(eps, cfg)


# ---------------------------------------------------------------------------
# fast tier: routing policy on stubs
# ---------------------------------------------------------------------------

def test_routes_and_streams_exactly_once(stubs):
    a = stubs()
    r = make_router([a])
    got = []
    f = r.submit([1, 2, 3], max_new_tokens=6,
                 stream_cb=lambda k, t: got.append(t))
    out = f.result(timeout=10)
    assert out == stub_tokens([1, 2, 3], 6)
    assert got == out                       # each token streamed exactly once
    c = r.counters()
    assert c["completed"] == 1 and c["retried"] == 0


def test_failover_mid_stream_is_exactly_once(stubs):
    # r0 dies after 3 token frames; r1 replays from the delivered index.
    dead = stubs(die_after=3)
    live = stubs()
    r = make_router([dead, live], affinity_prefix_tokens=0)
    # park the router on the dying stub by making the live one look busy
    live.queue_depth = 5
    got = []
    f = r.submit([4, 4], max_new_tokens=6,
                 stream_cb=lambda k, t: got.append(t))
    out = f.result(timeout=10)
    assert out == stub_tokens([4, 4], 6)
    assert got == out                       # no duplicates across the retry
    assert r.counters()["retried"] >= 1
    # the retry resumed, not restarted: second submit carried from=3
    froms = {k: frm for k, frm in dead.submits + live.submits}
    assert froms[f.request_id] == 3 or any(
        frm == 3 for _, frm in live.submits)


def test_retry_budget_exhaustion_poisons(stubs):
    a = stubs(die_after=0)                  # EOF before any token, always
    r = make_router([a], retry_budget=2)
    f = r.submit([7], max_new_tokens=4)
    with pytest.raises(RequestPoisonedError) as ei:
        f.result(timeout=10)
    assert ei.value.attempts == 3           # 1 first try + 2 retries
    c = r.counters()
    assert c["poisoned"] == 1 and c["completed"] == 0


def test_rejection_reroutes_without_burning_budget(stubs):
    full = stubs(reject="queue_full")
    live = stubs()
    r = make_router([full, live], retry_budget=0,   # ANY failure would poison
                    affinity_prefix_tokens=0)
    live.queue_depth = 5                    # bias the first pick to `full`
    out = r.submit([2, 2], max_new_tokens=6).result(timeout=10)
    assert out == stub_tokens([2, 2], 6)
    c = r.counters()
    assert c["completed"] == 1 and c["poisoned"] == 0
    assert c["rejected"] >= 1 and c["retried"] == 0


def test_draining_rejection_leaves_rotation(stubs):
    draining = stubs(reject="draining")
    live = stubs()
    r = make_router([draining, live], affinity_prefix_tokens=0)
    live.queue_depth = 5
    out = r.submit([3, 3], max_new_tokens=6).result(timeout=10)
    assert out == stub_tokens([3, 3], 6)
    assert r.counters()["drained"] >= 1
    ep = next(e for e in r.probe_all(force=False) if e.name == "r0")
    assert ep.draining                      # out of rotation
    # next request never touches the draining replica
    n0 = len(draining.submits)
    r.submit([5], max_new_tokens=6).result(timeout=10)
    assert len(draining.submits) == n0


def test_shed_on_class_budget(stubs):
    a = stubs()
    r = make_router([a], max_inflight_tokens={"bulk": 10})
    with pytest.raises(FleetOverloadError) as ei:
        r.submit([1] * 8, max_new_tokens=8, request_class="bulk")
    assert ei.value.reason == "class_budget"
    assert ei.value.retry_after_s == pytest.approx(0.25)
    assert r.counters()["shed"] == 1
    # other classes are not capped by bulk's budget
    assert r.submit([1] * 8, max_new_tokens=8).result(timeout=10)


def test_shed_when_every_routable_replica_saturated(stubs):
    a = stubs(queue_depth=100)
    b = stubs(queue_depth=100)
    r = make_router([a, b], saturation_queue_depth=32)
    with pytest.raises(FleetOverloadError) as ei:
        r.submit([1], max_new_tokens=4)
    assert ei.value.reason == "saturated"


def test_affinity_same_prefix_same_replica(stubs):
    a, b = stubs(), stubs()
    r = make_router([a, b], affinity_prefix_tokens=4)
    prefix = [9, 8, 7, 6]
    futs = [r.submit(prefix + [i], max_new_tokens=4) for i in range(6)]
    for f in futs:
        f.result(timeout=10)
    # every shared-prefix request landed on ONE replica
    assert (len(a.submits), len(b.submits)) in ((6, 0), (0, 6))


def test_affinity_falls_back_when_target_unhealthy(stubs):
    a, b = stubs(), stubs()
    r = make_router([a, b], affinity_prefix_tokens=4)
    prefix = [9, 8, 7, 6]
    r.submit(prefix + [0], max_new_tokens=4).result(timeout=10)
    target, other = (a, b) if a.submits else (b, a)
    target.close()                          # affinity target dies
    out = r.submit(prefix + [1], max_new_tokens=4).result(timeout=10)
    assert out == stub_tokens(prefix + [1], 6)
    assert len(other.submits) >= 1          # least-loaded fallback took it


def test_router_gauges_under_fleet_router(stubs):
    from deepspeed_tpu_torch.telemetry.registry import MetricsRegistry

    a = stubs()
    reg = MetricsRegistry()
    r = make_router([a])
    r.export_gauges(reg)
    r.submit([1], max_new_tokens=4).result(timeout=10)
    vals = reg.as_dict()
    assert vals["Fleet/router/routed"] == 1.0
    assert vals["Fleet/router/completed"] == 1.0
    assert vals["Fleet/router/shed_rate"] == 0.0
    for k in ("retried", "shed", "drained"):
        assert f"Fleet/router/{k}" in vals


def test_slo_rule_resolves_router_alias():
    from deepspeed_tpu_torch.telemetry.slo import SloEngine, SloRule

    rule = SloRule("Router/shed_rate", max=0.1)
    v = SloEngine._lookup({"Fleet/router/shed_rate": 0.5}, rule)
    assert v == 0.5


def test_fleet_config_block_parses_and_validates():
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig

    cfg = DeepSpeedConfig({"train_batch_size": 1, "fleet": {
        "replicas": 4, "retry_budget": 3,
        "max_inflight_tokens": {"default": 4096, "bulk": 1024}}},
        world_size=1)
    fc = cfg.fleet_config
    assert fc.enabled and fc.replicas == 4 and fc.retry_budget == 3
    assert fc.max_inflight_tokens == {"default": 4096, "bulk": 1024}
    assert not DeepSpeedConfig({"train_batch_size": 1},
                               world_size=1).fleet_config.enabled
    with pytest.raises(ValueError, match="retry_budget"):
        DeepSpeedConfig({"train_batch_size": 1,
                         "fleet": {"retry_budget": -1}}, world_size=1)
    with pytest.raises(ValueError, match="max_inflight_tokens"):
        DeepSpeedConfig({"train_batch_size": 1,
                         "fleet": {"max_inflight_tokens": {"x": -5}}},
                        world_size=1)


# ---------------------------------------------------------------------------
# satellite: scheduler keeps the original enqueue timestamp on requeue
# ---------------------------------------------------------------------------

def test_requeue_keeps_enqueue_timestamp():
    sched = ContinuousBatchingScheduler(max_queue=4, buckets=(8,))
    req = sched.submit([1, 2], timeout_s=10.0)
    t0 = req.submit_time
    popped = sched.pop_next()
    assert popped is req
    sched.requeue_front(req)                # PoolExhaustedError bounce
    assert sched.pop_next().submit_time == t0   # same Request, same clock


def test_backdated_submit_keeps_deadline_running():
    sched = ContinuousBatchingScheduler(max_queue=4, buckets=(8,))
    aged = time.monotonic() - 9.5
    req = sched.submit([1, 2], timeout_s=10.0, submitted_at=aged)
    assert req.submit_time == pytest.approx(aged)
    # 9.5s already spent elsewhere: the deadline fires in 0.5s, not 10
    assert not req.deadline_exceeded(time.monotonic())
    assert req.deadline_exceeded(time.monotonic() + 1.0)
    fresh = Request(0, [1], 4, timeout_s=10.0)
    assert not fresh.deadline_exceeded(time.monotonic() + 1.0)


# ---------------------------------------------------------------------------
# satellite: fleet fault-injection arms
# ---------------------------------------------------------------------------

def test_kill_replica_arm_fires_at_step(monkeypatch):
    fi = ServingFaultInjector()
    fi.arm_serving("kill_replica", at_step=3)
    kills = []
    monkeypatch.setattr(fi, "_kill", lambda: kills.append(True))
    for step in (0, 1, 2):
        fi.maybe_kill_replica(step)
    assert not kills
    fi.maybe_kill_replica(3)
    assert kills == [True]
    assert fi.fired["kill_replica"] == 1


def test_slow_replica_arm_bounded_by_times():
    fi = ServingFaultInjector(
        {"slow_replica": {"seconds": 0.125, "times": 2}})
    assert fi.reply_delay_s() == 0.125
    assert fi.reply_delay_s() == 0.125
    assert fi.reply_delay_s() == 0.0        # shots spent
    assert fi.fired["slow_replica"] == 2


def test_reject_admission_arm_spends_shots():
    fi = ServingFaultInjector({"reject_admission": {"times": 1}})
    assert fi.admission_rejected()
    assert not fi.admission_rejected()


def test_fleet_arms_coexist_with_step_arms():
    fi = ServingFaultInjector({"kill_replica": {"at_step": 9},
                               "slow_decode": {"at_step": 1,
                                               "seconds": 0.0}})
    fi.maybe_slow_decode(1)
    assert fi.fired["slow_decode"] == 1
    with pytest.raises(ValueError, match="unknown serving fault point"):
        fi.arm_serving("nope")


def test_slow_replica_delays_socket_replies(stubs):
    a = stubs(reply_delay_s=0.3)            # stands in for the armed delay
    b = stubs()
    r = make_router([a, b], attempt_timeout_s=0.1,
                    affinity_prefix_tokens=0, retry_budget=2)
    b.queue_depth = 5                       # bias first pick to the slow one
    out = r.submit([6], max_new_tokens=6).result(timeout=10)
    assert out == stub_tokens([6], 6)       # timed out on a, finished on b
    assert r.counters()["retried"] >= 1


# ---------------------------------------------------------------------------
# real engines behind in-process replicas (tiny GPT-2 on the CPU)
# ---------------------------------------------------------------------------

MODEL = {"vocab_size": 64, "hidden_size": 64, "num_hidden_layers": 2,
         "num_attention_heads": 4, "max_position_embeddings": 32}
SERVING = {"max_slots": 4, "max_queue": 16, "max_seq_len": 32, "prompt_buckets": [4, 8, 16],
           "kv_page_tokens": 4}
PROMPTS = [[3, 1, 4, 1], [3, 1, 4, 2], [2, 7, 1, 8], [2, 7, 1, 9]]


def _tiny_model():
    import torch

    from deepspeed_tpu_torch.inference.serving.replica import build_model

    torch.manual_seed(0)
    return build_model({"model": MODEL, "seed": 0}, device="cpu")


@pytest.fixture(scope="module")
def tiny():
    return _tiny_model()


def _reference(model, cfg, prompts, n_new):
    import torch

    from deepspeed_tpu_torch.inference.generation import generate

    return [generate(model, cfg, torch.tensor([p]), n_new, device="cpu")[0].tolist()
            for p in prompts]


class _InProcessReplica:
    """A ReplicaServer over a real engine whose death can be simulated:
    ``kill()`` shuts every open connection and the listener and ends the
    serving loop after the step it is called from."""

    def __init__(self, model, cfg, injector=None):
        from deepspeed_tpu_torch.inference.serving import (
            ReplicaServer,
            ServingConfig,
            ServingEngine,
        )

        self.engine = ServingEngine(model, cfg, ServingConfig(**SERVING), device="cpu",
                                    injector=injector)
        self.server = ReplicaServer(self.engine)
        self.conns = []
        serve = self.server._serve_conn

        def tracked(conn):
            self.conns.append(conn)
            serve(conn)

        self.server._serve_conn = tracked
        self.server.start()
        self.port = self.server.port

    def kill(self):
        for conn in list(self.conns):
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        try:
            self.server._lsock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.engine._stop.set()

    def close(self):
        self.server._closing.set()
        self.server.close()


def test_kill_replica_mid_decode_loses_nothing_in_process(tiny):
    """One replica dies inside a decode step (its ``kill_replica`` arm);
    every accepted request completes, each output equals the port's
    ``generate()`` bit for bit, and no token reaches ``stream_cb``
    twice."""
    model, cfg = tiny
    fi = ServingFaultInjector({"kill_replica": {"at_step": 3}})
    doomed = _InProcessReplica(model, cfg, injector=fi)
    fi._kill = doomed.kill
    safe = _InProcessReplica(model, cfg)
    r = Router([ReplicaEndpoint("doomed", "127.0.0.1", doomed.port),
                ReplicaEndpoint("safe", "127.0.0.1", safe.port)],
               FleetConfig(enabled=True, retry_budget=3, retry_backoff_s=0.01,
                           attempt_timeout_s=60.0, health_ttl_s=0.05,
                           affinity_prefix_tokens=0))
    try:
        n_new = 10
        streamed = {i: [] for i in range(len(PROMPTS))}
        futs = [r.submit(p, max_new_tokens=n_new,
                         stream_cb=lambda k, t, i=i: streamed[i].append(t))
                for i, p in enumerate(PROMPTS)]
        outs = [f.result(timeout=120) for f in futs]
        assert fi.fired["kill_replica"] == 1
        assert outs == _reference(model, cfg, PROMPTS, n_new)
        for i, out in enumerate(outs):
            assert streamed[i] == out       # exactly-once streaming
        c = r.counters()
        assert c["completed"] == len(PROMPTS) and c["poisoned"] == 0
        assert c["retried"] >= 1
    finally:
        r.close()
        doomed.close()
        safe.close()


def test_drain_finishes_inflight_and_new_requests_go_elsewhere_in_process(tiny):
    """A planned drain mid-decode finishes the accepted request, rejects
    new keys as draining (the router takes the replica out of rotation)
    and ``drain_and_stop`` reports a clean drain."""
    model, cfg = tiny
    primary, backup = _InProcessReplica(model, cfg), _InProcessReplica(model, cfg)
    r = Router([ReplicaEndpoint("primary", "127.0.0.1", primary.port),
                ReplicaEndpoint("backup", "127.0.0.1", backup.port)],
               FleetConfig(enabled=True, retry_budget=3, retry_backoff_s=0.01,
                           attempt_timeout_s=60.0, health_ttl_s=0.05,
                           affinity_prefix_tokens=0))
    try:
        # park the request on the primary: the backup looks loaded
        eps = {e.name: e for e in r.probe_all()}
        now = time.monotonic()
        eps["backup"].load_hint = 50
        eps["backup"].last_probe = now + 30.0
        eps["primary"].healthy = True
        eps["primary"].load_hint = 0
        eps["primary"].last_probe = now + 30.0
        started = threading.Event()
        prompt, n_new = [5, 4, 3, 2], 24
        f = r.submit(prompt, max_new_tokens=n_new, timeout_s=120.0,
                     stream_cb=lambda k, t: started.set())
        assert started.wait(60), "request never started decoding on the primary"
        primary.server.begin_drain()
        assert primary.engine.draining
        out = f.result(timeout=120)          # completes despite the drain
        assert out == _reference(model, cfg, [prompt], n_new)[0]
        eps["backup"].load_hint = 0
        eps["backup"].last_probe = 0.0
        eps["primary"].last_probe = 0.0
        before = backup.server._tokens_total
        out2 = r.submit([1, 2, 3], max_new_tokens=6).result(timeout=120)
        assert out2 == _reference(model, cfg, [[1, 2, 3]], 6)[0]
        assert backup.server._tokens_total == before + 6
        assert r.counters()["poisoned"] == 0
        assert primary.server.drain_and_stop() is True
    finally:
        r.close()
        primary.close()
        backup.close()


# ---------------------------------------------------------------------------
# slow tier: real replica processes
# ---------------------------------------------------------------------------

def _spawn_replica(tmp_path, name, serving_overrides=None, fleet=None):
    spec = {"model": MODEL, "seed": 0, "device": "cpu", "ds_config": {
        "train_batch_size": 1,
        "serving": {**SERVING, **(serving_overrides or {})},
        **({"fleet": fleet} if fleet else {})}}
    cfg_path = tmp_path / f"{name}.json"
    cfg_path.write_text(json.dumps(spec))
    proc = subprocess.Popen(
        [sys.executable, "-m", "deepspeed_tpu_torch.inference.serving.replica",
         "--config", str(cfg_path), "--port", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    line = proc.stdout.readline()           # blocks until "ready"
    if not line:
        proc.kill()
        raise RuntimeError(f"replica {name} died before ready")
    ready = json.loads(line)
    assert ready.get("ready")
    return proc, int(ready["port"])


@pytest.mark.slow
@pytest.mark.faults
def test_kill_replica_mid_decode_loses_nothing(tmp_path, tiny):
    """The failover oracle across processes: one replica SIGKILLs itself
    inside a decode step; every accepted request completes and equals
    ``generate()`` bit for bit, streamed exactly once."""
    model, cfg = tiny
    procs = []
    try:
        doomed, p0 = _spawn_replica(
            tmp_path, "doomed",
            serving_overrides={"fault_injection": {"kill_replica": {"at_step": 3}}})
        safe, p1 = _spawn_replica(tmp_path, "safe")
        procs = [doomed, safe]
        r = Router([ReplicaEndpoint("doomed", "127.0.0.1", p0),
                    ReplicaEndpoint("safe", "127.0.0.1", p1)],
                   FleetConfig(enabled=True, retry_budget=3, retry_backoff_s=0.05,
                               attempt_timeout_s=300.0, health_ttl_s=0.1,
                               affinity_prefix_tokens=0))
        n_new = 10
        streamed = {i: [] for i in range(len(PROMPTS))}
        futs = [r.submit(p, max_new_tokens=n_new,
                         stream_cb=lambda k, t, i=i: streamed[i].append(t))
                for i, p in enumerate(PROMPTS)]
        outs = [f.result(timeout=600) for f in futs]
        assert doomed.wait(timeout=60) == -signal.SIGKILL
        assert outs == _reference(model, cfg, PROMPTS, n_new)
        for i, out in enumerate(outs):
            assert streamed[i] == out
        c = r.counters()
        assert c["completed"] == len(PROMPTS) and c["poisoned"] == 0
    finally:
        for p in procs:
            p.kill()
            p.wait(timeout=30)


@pytest.mark.slow
@pytest.mark.faults
def test_sigterm_drains_without_killing_inflight(tmp_path, tiny):
    """SIGTERM mid-decode finishes accepted work, rejects new keys as
    draining, and the replica exits ``EXIT_PREEMPTED``."""
    from deepspeed_tpu_torch.launcher.supervisor import EXIT_PREEMPTED

    model, cfg = tiny
    procs = []
    try:
        primary, p0 = _spawn_replica(tmp_path, "primary")
        backup, p1 = _spawn_replica(tmp_path, "backup")
        procs = [primary, backup]
        r = Router([ReplicaEndpoint("primary", "127.0.0.1", p0),
                    ReplicaEndpoint("backup", "127.0.0.1", p1)],
                   FleetConfig(enabled=True, retry_budget=3, retry_backoff_s=0.05,
                               attempt_timeout_s=300.0, health_ttl_s=0.1,
                               affinity_prefix_tokens=0))
        eps = {e.name: e for e in r.probe_all()}
        now = time.monotonic()
        eps["backup"].load_hint = 50
        eps["backup"].last_probe = now + 30.0
        eps["primary"].healthy = True
        eps["primary"].load_hint = 0
        eps["primary"].last_probe = now + 30.0
        started = threading.Event()
        prompt, n_new = [5, 4, 3, 2], 24
        f = r.submit(prompt, max_new_tokens=n_new, timeout_s=600.0,
                     stream_cb=lambda k, t: started.set())
        assert started.wait(300), "request never started decoding on the primary"
        primary.send_signal(signal.SIGTERM)
        out = f.result(timeout=600)
        assert out == _reference(model, cfg, [prompt], n_new)[0]
        assert primary.wait(timeout=120) == EXIT_PREEMPTED
        eps["backup"].load_hint = 0           # the bias ends with the drain
        eps["backup"].last_probe = 0.0
        out2 = r.submit([1, 2, 3], max_new_tokens=6).result(timeout=600)
        assert out2 == _reference(model, cfg, [[1, 2, 3]], 6)[0]
        assert r.counters()["poisoned"] == 0
    finally:
        for p in procs:
            p.kill()
            p.wait(timeout=30)


def test_launch_collector_serves_the_workers_and_the_supervisor():
    """``launch --collector_port``: a FleetCollector over the supervised
    workers' endpoints (worker i at ``--worker_telemetry_port`` + i) that
    merges the supervisor's own gauges, served on its port."""
    import urllib.request

    from deepspeed_tpu_torch import telemetry
    from deepspeed_tpu_torch.launcher import launch
    from deepspeed_tpu_torch.launcher.supervisor import WorkerSupervisor

    sup = WorkerSupervisor(["true"], env={}, local_envs=[{}, {}], worker_port=41000, rank=3)
    collector = launch._start_collector(sup, 0, node_rank=0)
    try:
        assert sorted(collector._endpoints) == [3, 4]
        assert [ep["url"] for _, ep in sorted(collector._endpoints.items())] == \
            sup.worker_endpoints
        with urllib.request.urlopen(collector.server.url + "/fleet/metrics",
                                    timeout=30) as resp:
            body = resp.read().decode()
        assert resp.status == 200 and "restarts_consecutive" in body
    finally:
        collector.stop()
        telemetry.configure(False)
        telemetry.get_tracer().clear()
        for name in ("Supervisor/restarts", "Supervisor/worker",
                     "Fleet/rank3/restarts_consecutive", "Fleet/rank3/breaker_open"):
            telemetry.get_registry().unregister(name)
