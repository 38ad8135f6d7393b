"""The port's self-healing fleet: autoscaler, degrade ladder, breakers,
chaos.

The JAX package's ``tests/unit/test_selfheal.py`` fast tier on the port's
copies, against in-process stubs and injected clocks: the
``CrashLoopBreaker`` and ``DegradeLadder`` state machines, the
supervisor's breaker and per-rank gauges, rung-3 class shedding and
stale-health routing in the Router, shed re-admission honoring
``retry_after_s``, the Autoscaler's hysteresis against a fake spawner
and a 20-episode seeded ``ChaosHarness`` schedule over stub replicas;
and the memory-tier chaos harness's refusals. The ``slow`` tier spawns
real replica processes of the port (tiny GPT-2 on the CPU): the
autoscaler scaling 1 -> 2 on a firing TTFT rule and draining back (the
drained replica exiting ``EXIT_PREEMPTED``), and a chaos schedule of all
five fault kinds held to ``generate()``.
"""

import threading
import time

import pytest

from deepspeed_tpu_torch.inference.serving.autoscaler import (
    Autoscaler,
    ProcessReplicaSpawner,
)
from deepspeed_tpu_torch.inference.serving.chaos import ChaosHarness
from deepspeed_tpu_torch.inference.serving.config import (
    AutoscaleConfig,
    DegradeConfig,
    FleetConfig,
)
from deepspeed_tpu_torch.inference.serving.degrade import (
    MAX_RUNG,
    DegradeLadder,
    rung_name,
)
from deepspeed_tpu_torch.inference.serving.router import (
    FleetOverloadError,
    ReplicaEndpoint,
    Router,
)
from deepspeed_tpu_torch.launcher.supervisor import (
    EXIT_PREEMPTED,
    CrashLoopBreaker,
    WorkerSupervisor,
)
from tests.test_torch_fleet_router import (
    FAST_CFG,
    StubReplica,
    make_router,
    stub_tokens,
    stubs,  # noqa: F401  (fixture re-export)
)


# ---------------------------------------------------------------------------
# CrashLoopBreaker: closed -> open -> half_open -> closed
# ---------------------------------------------------------------------------

def test_breaker_opens_quarantines_and_probes():
    t = [0.0]
    b = CrashLoopBreaker(threshold=3, window_s=10.0, cooldown_s=5.0,
                         clock=lambda: t[0])
    assert not b.record_failure()
    t[0] = 1.0
    assert not b.record_failure()
    t[0] = 2.0
    assert b.record_failure()               # threshold inside window: OPEN
    assert b.is_open and b.open_count == 1
    assert b.restart_delay_s() == pytest.approx(5.0)
    assert not b.allow_probe()              # still quarantined
    t[0] = 7.5
    assert b.allow_probe() and b.state == "half_open"
    assert b.record_failure()               # the probe failed: re-open
    assert b.is_open and b.open_count == 2
    t[0] = 13.0
    assert b.allow_probe()
    b.record_success()                      # probe ran clean: close
    assert b.state == "closed" and b.restart_delay_s() == 0.0


def test_breaker_window_expires_old_failures():
    t = [0.0]
    b = CrashLoopBreaker(threshold=2, window_s=1.0, clock=lambda: t[0])
    assert not b.record_failure()
    t[0] = 5.0                              # first failure aged out
    assert not b.record_failure()
    t[0] = 5.5
    assert b.record_failure()


def test_breaker_from_config_respects_enabled():
    assert CrashLoopBreaker.from_config(None) is None
    assert CrashLoopBreaker.from_config({"enabled": False}) is None
    b = CrashLoopBreaker.from_config(
        {"threshold": 5, "window_s": 9.0, "cooldown_s": 2.0})
    assert b.threshold == 5 and b.window_s == 9.0 and b.cooldown_s == 2.0


def test_supervisor_breaker_quarantines_crash_loop(tmp_path):
    """A worker that dies the same way every time opens its breaker, and
    the breaker's quarantine dominates the restart delay; the per-rank
    gauges expose the state; a clean exit resets both."""
    import sys as _sys

    from deepspeed_tpu_torch.telemetry.registry import MetricsRegistry

    sup = WorkerSupervisor(
        [_sys.executable, "-c", "import sys; sys.exit(7)"],
        max_restarts=3, backoff_s=0.0,
        breaker={"threshold": 2, "window_s": 60.0, "cooldown_s": 0.05},
        rank=3)
    reg = MetricsRegistry()
    sup.export_gauges(reg)
    rc = sup.run()
    assert rc == 7
    assert sup.consecutive_failures == 4        # 1 first try + 3 restarts
    assert sup.breaker.open_count >= 1
    vals = reg.as_dict()
    assert vals["Fleet/rank3/restarts_consecutive"] == 4.0
    assert "Fleet/rank3/breaker_open" in vals
    # a clean run resets the consecutive count and closes the breaker
    ok = WorkerSupervisor([_sys.executable, "-c", "pass"],
                          breaker={"threshold": 2}, rank=3)
    assert ok.run() == 0
    assert ok.consecutive_failures == 0
    assert ok.breaker.state == "closed"


def test_supervisor_preempted_exit_resets_failure_count():
    import sys as _sys

    # one crash, then EXIT_PREEMPTED, then clean: the preempted exit must
    # clear the failure streak (it is a polite drain, not a failure)
    script = (
        "import os, sys\n"
        "p = os.environ['STATE']\n"
        "n = int(open(p).read()) if os.path.exists(p) else 0\n"
        "open(p, 'w').write(str(n + 1))\n"
        "sys.exit([1, 99, 0][n])\n")
    import tempfile
    with tempfile.TemporaryDirectory() as td:
        import os
        env = dict(os.environ, STATE=os.path.join(td, "n"))
        sup = WorkerSupervisor([_sys.executable, "-c", script], env=env,
                               max_restarts=5, backoff_s=0.0,
                               breaker={"threshold": 3})
        assert sup.run() == 0
        assert sup.consecutive_failures == 0
        assert sup.breaker.state == "closed"
        assert [c for c, _ in sup.exit_history] == [
            "crash", "preempted", "clean"]


# ---------------------------------------------------------------------------
# DegradeLadder: one rung per sustained window, both directions
# ---------------------------------------------------------------------------

def test_ladder_escalates_and_recovers_rung_by_rung():
    t = [0.0]
    changes = []
    lad = DegradeLadder(
        DegradeConfig(enabled=True, escalate_after_s=1.0, recover_after_s=2.0),
        on_change=lambda o, n, r: changes.append((o, n)),
        clock=lambda: t[0])
    lad.update(True)
    t[0] = 0.5
    assert lad.update(True) == 0            # pressure not yet sustained
    t[0] = 1.0
    assert lad.update(True) == 1            # ONE rung, window re-arms
    t[0] = 1.5
    assert lad.update(True) == 1            # never two rungs per window
    t[0] = 2.0
    assert lad.update(True) == 2
    t[0] = 3.0
    assert lad.update(True) == 3
    t[0] = 9.0
    assert lad.update(True) == MAX_RUNG     # clamped
    lad.update(False)
    t[0] = 11.0
    assert lad.update(False) == 2           # rung-by-rung recovery
    t[0] = 13.0
    assert lad.update(False) == 1
    t[0] = 15.0
    assert lad.update(False) == 0
    assert changes == [(0, 1), (1, 2), (2, 3), (3, 2), (2, 1), (1, 0)]
    assert lad.transitions == 6
    assert rung_name(2) == "budget_shrink"


def test_ladder_set_rung_resets_hysteresis():
    t = [0.0]
    lad = DegradeLadder(DegradeConfig(enabled=True, escalate_after_s=0.5,
                                      recover_after_s=0.5),
                        clock=lambda: t[0])
    lad.update(True)
    t[0] = 0.4
    assert lad.set_rung(3) == 3
    # the pending pressure window must not immediately escalate further
    # (clamped anyway) nor recover; clocks restarted
    assert lad.update(False) == 3
    t[0] = 0.8
    assert lad.update(False) == 3           # quiet window restarted at 0.4
    t[0] = 1.0
    assert lad.update(False) == 2


# ---------------------------------------------------------------------------
# Router: rung-3 shedding, stale health, shed re-admission
# ---------------------------------------------------------------------------

def test_router_rung3_sheds_nondefault_classes(stubs):
    a = stubs()
    r = make_router([a])
    r.set_degrade_rung(3)
    with pytest.raises(FleetOverloadError) as ei:
        r.submit([1, 2], max_new_tokens=4, request_class="bulk")
    assert ei.value.reason == "degraded"
    assert ei.value.retry_after_s == pytest.approx(0.25)
    # the protected default class still gets served at rung 3
    assert r.submit([1, 2], max_new_tokens=4).result(timeout=10)
    r.set_degrade_rung(0)
    assert r.submit([1, 2], max_new_tokens=4,
                    request_class="bulk").result(timeout=10)


def test_router_rung3_honors_configured_shed_classes(stubs):
    a = stubs()
    cfg = FleetConfig(enabled=True, **FAST_CFG)
    cfg.degrade = DegradeConfig(enabled=True, shed_classes=("batch",))
    r = Router([a.endpoint("r0")], cfg)
    r.set_degrade_rung(3)
    with pytest.raises(FleetOverloadError):
        r.submit([1], max_new_tokens=4, request_class="batch")
    # classes OUTSIDE the configured list ride through, even non-default
    assert r.submit([1], max_new_tokens=4,
                    request_class="bulk").result(timeout=10)


def test_router_treats_stale_health_as_unhealthy(stubs):
    a, b = stubs(), stubs()
    r = make_router([a, b], affinity_prefix_tokens=0)   # ttl 0.02s
    eps = {e.name: e for e in r.probe_all()}
    now = time.monotonic()
    # r0's cached view says healthy, but the snapshot is ancient and the
    # probe is pinned fresh (so it won't refresh): don't route on it
    eps["r0"].healthy = True
    eps["r0"].last_ok = now - 1.0
    eps["r0"].last_probe = now + 30.0
    eps["r1"].last_probe = now + 30.0
    eps["r1"].last_ok = now + 30.0
    assert not r._routable(eps["r0"])
    assert r._routable(eps["r1"])
    r.submit([5, 5], max_new_tokens=4).result(timeout=10)
    assert len(a.submits) == 0 and len(b.submits) == 1


def test_router_stale_window_disabled_when_ttl_zero(stubs):
    a = stubs()
    r = make_router([a], health_ttl_s=0.0)
    ep = r.endpoints()[0]
    ep.last_ok = time.monotonic() - 100.0
    assert r._routable(ep)


def test_submit_shed_retries_honor_retry_after_hint(stubs):
    a = stubs(queue_depth=100)              # saturated: sheds at the door
    r = make_router([a], saturation_queue_depth=8, shed_retry_after_s=0.05)

    def relieve():
        time.sleep(0.12)
        a.queue_depth = 0

    threading.Thread(target=relieve, daemon=True).start()
    t0 = time.monotonic()
    out = r.submit([9, 9], max_new_tokens=4, shed_retries=10).result(
        timeout=10)
    waited = time.monotonic() - t0
    assert out == stub_tokens([9, 9], 6)
    assert waited >= 0.1                    # actually slept on the hint
    assert r.counters()["shed"] >= 1


def test_submit_shed_retries_exhaustion_reraises(stubs):
    a = stubs(queue_depth=100)
    r = make_router([a], saturation_queue_depth=8, shed_retry_after_s=0.01)
    t0 = time.monotonic()
    with pytest.raises(FleetOverloadError):
        r.submit([1], max_new_tokens=4, shed_retries=3)
    assert time.monotonic() - t0 >= 0.025   # slept between re-admissions
    assert r.counters()["shed"] == 4        # initial + 3 retries


def test_router_add_remove_endpoint(stubs):
    a, b = stubs(), stubs()
    r = make_router([a])
    ep_b = r.add_endpoint(b.endpoint("r9"))
    assert [e.name for e in r.endpoints()] == ["r0", "r9"]
    with pytest.raises(ValueError, match="already routed"):
        r.add_endpoint(b.endpoint("r9"))
    removed = r.remove_endpoint("r9")
    assert removed is ep_b and removed.draining
    with pytest.raises(ValueError, match="last endpoint"):
        r.remove_endpoint("r0")
    with pytest.raises(ValueError, match="no endpoint"):
        r.remove_endpoint("nope")
    assert r.submit([1], max_new_tokens=4).result(timeout=10)


# ---------------------------------------------------------------------------
# Autoscaler: hysteresis over a fake spawner
# ---------------------------------------------------------------------------

class FakeHandle:
    def __init__(self, name, stub):
        self.name, self.host, self.port = name, "127.0.0.1", stub.port
        self.stub = stub
        self._alive = True

    def alive(self):
        return self._alive

    def endpoint(self):
        return ReplicaEndpoint(self.name, self.host, self.port)


class FakeSpawner:
    """In-process spawner: each 'replica' is a StubReplica."""

    def __init__(self):
        self.made = []
        self.drained = []
        self.killed = []
        self._seq = 0

    def spawn(self, name=None):
        self._seq += 1
        stub = StubReplica()
        h = FakeHandle(name or f"fake-{self._seq}", stub)
        self.made.append(h)
        return h

    def drain(self, handle, wait_s=0.0):
        handle._alive = False
        handle.stub.close()
        self.drained.append(handle.name)
        return True

    def kill(self, handle):
        handle._alive = False
        handle.stub.close()
        self.killed.append(handle.name)

    def close_all(self):
        for h in self.made:
            h.stub.close()


@pytest.fixture
def fake_spawner():
    sp = FakeSpawner()
    yield sp
    sp.close_all()


def test_autoscaler_scales_up_then_down_with_hysteresis(fake_spawner):
    t = [0.0]
    firing = [False]
    h0 = fake_spawner.spawn("base")
    router = Router([h0.endpoint()], FleetConfig(enabled=True, **FAST_CFG))
    auto = Autoscaler(
        router, fake_spawner,
        AutoscaleConfig(enabled=True, min_replicas=1, max_replicas=2,
                        warm_spares=1, up_after_s=1.0, down_after_s=2.0,
                        cooldown_s=0.5),
        alerts=lambda: firing[0], replicas=[h0], clock=lambda: t[0])

    assert auto.step() is None              # quiet: just refills the spare
    assert auto.stats()["warm_spares"] == 1.0
    firing[0] = True
    assert auto.step() is None              # pressure starts its window
    t[0] = 0.5
    assert auto.step() is None              # not sustained yet
    t[0] = 1.0
    assert auto.step() == "up"              # attach the warm spare
    assert len(router.endpoints()) == 2
    assert auto.scale_ups == 1
    t[0] = 1.2
    assert auto.step() is None              # at max but cooldown holds
    t[0] = 2.5
    assert auto.step() == "degrade"         # no headroom: ladder instead
    firing[0] = False
    t[0] = 3.0
    assert auto.step() is None              # quiet window starts
    t[0] = 4.0
    assert auto.step() is None
    t[0] = 5.1
    assert auto.step() == "down"            # sustained quiet: drain one
    assert len(router.endpoints()) == 1
    assert auto.scale_downs == 1
    assert fake_spawner.drained             # SIGTERM path was used
    t[0] = 5.2
    assert auto.step() is None              # min_replicas floor holds
    router.close()


def test_autoscaler_at_ceiling_climbs_ladder_and_recovers(fake_spawner):
    t = [0.0]
    firing = [True]
    h0 = fake_spawner.spawn("base")
    router = Router([h0.endpoint()], FleetConfig(enabled=True, **FAST_CFG))
    ladder = DegradeLadder(
        DegradeConfig(enabled=True, escalate_after_s=0.5, recover_after_s=0.5),
        clock=lambda: t[0])
    auto = Autoscaler(
        router, fake_spawner,
        AutoscaleConfig(enabled=True, min_replicas=1, max_replicas=1,
                        warm_spares=0, up_after_s=0.1, cooldown_s=0.0),
        alerts=lambda: firing[0], replicas=[h0], ladder=ladder,
        clock=lambda: t[0])
    auto.step()
    t[0] = 0.6
    assert auto.step() == "degrade"
    assert ladder.rung == 1                 # pushed through the ladder...
    assert router.degrade_rung == 1         # ...and fanned to the router
    t[0] = 1.2
    auto.step()
    assert ladder.rung == 2
    firing[0] = False
    t[0] = 2.0
    auto.step()
    t[0] = 2.8
    auto.step()
    assert ladder.rung == 1                 # rung-by-rung recovery
    t[0] = 3.6
    auto.step()
    assert ladder.rung == 0 and router.degrade_rung == 0
    router.close()


def test_autoscaler_unreadable_alerts_holds_state(fake_spawner):
    t = [0.0]
    h0 = fake_spawner.spawn("base")
    router = Router([h0.endpoint()], FleetConfig(enabled=True, **FAST_CFG))

    def broken():
        raise OSError("alerts endpoint down")

    auto = Autoscaler(
        router, fake_spawner,
        AutoscaleConfig(enabled=True, warm_spares=0, up_after_s=0.0,
                        cooldown_s=0.0),
        alerts=broken, replicas=[h0], clock=lambda: t[0])
    for _ in range(5):
        t[0] += 1.0
        assert auto.step() is None
    assert len(router.endpoints()) == 1 and auto.scale_ups == 0
    router.close()


# ---------------------------------------------------------------------------
# ChaosHarness: a full seeded schedule over stub replicas (fast tier)
# ---------------------------------------------------------------------------

def test_chaos_schedule_20_episodes_on_stubs(fake_spawner):
    """The chaos bar, fast: >= 20 seeded episodes composing hard-kill,
    drain and overload against stub replicas, every completion bitwise
    vs the stub oracle, zero stuck requests, recovery bounded, and the
    fleet converged at the end. (slow_replica/reject_admission need the
    real replica's inject op; the slow tier covers those.)"""
    h0, h1 = fake_spawner.spawn("s0"), fake_spawner.spawn("s1")
    for h in (h0, h1):
        h.stub.n_tokens = 8
    router = Router(
        [h0.endpoint(), h1.endpoint()],
        FleetConfig(enabled=True, **{**FAST_CFG, "retry_budget": 4,
                                     "affinity_prefix_tokens": 0,
                                     "shed_retry_after_s": 0.01}))
    # respawned stubs must produce 8 tokens too
    real_spawn = fake_spawner.spawn

    def spawn8(name=None):
        h = real_spawn(name)
        h.stub.n_tokens = 8
        return h

    fake_spawner.spawn = spawn8
    harness = ChaosHarness(
        router, fake_spawner,
        reference_fn=lambda p, n: stub_tokens(p, 8),
        replicas=[h0, h1], seed=7,
        faults=("kill_replica", "drain_replica", "overload"),
        max_new_tokens=8, request_timeout_s=30.0, recovery_timeout_s=30.0)
    report = harness.run(episodes=20)
    assert report["chaos_episodes"] == 20
    assert report["invariant_bitwise_ok"], report
    assert report["invariant_no_stuck"], report
    assert report["invariant_recovery_bounded"], report
    assert report["invariant_converged"], report
    assert report["completed_total"] > 0
    assert report.ok
    # the schedule actually composed multiple fault kinds
    kinds = [e["kind"] for e in report["episodes"]]
    assert len(set(kinds)) > 1
    router.close()


def test_chaos_rejects_unknown_fault_kind(fake_spawner):
    h0 = fake_spawner.spawn("x")
    router = Router([h0.endpoint()], FleetConfig(enabled=True, **FAST_CFG))
    with pytest.raises(ValueError, match="unknown fault kinds"):
        ChaosHarness(router, fake_spawner, lambda p, n: [], [],
                     faults=("kill_replica", "nope"))
    router.close()


# ---------------------------------------------------------------------------
# the memory-tier chaos harness
# ---------------------------------------------------------------------------

def test_memtier_chaos_rejects_unknown_kind():
    from deepspeed_tpu_torch.inference.serving.chaos import (
        MEMTIER_FAULT_KINDS,
        MemtierChaosHarness,
    )

    with pytest.raises(ValueError, match="unknown fault kinds"):
        MemtierChaosHarness(None, None, lambda p, n: [], [],
                            faults=MEMTIER_FAULT_KINDS + ("nope",))


# ---------------------------------------------------------------------------
# slow tier: real replica processes
# ---------------------------------------------------------------------------

def _replica_config(tmp_path, chaos=False):
    import json

    from tests.test_torch_fleet_router import MODEL, SERVING

    spec = {"model": MODEL, "seed": 0, "device": "cpu", "ds_config": {
        "train_batch_size": 1, "serving": SERVING}}
    if chaos:
        spec["chaos"] = True
    path = tmp_path / "replica.json"
    path.write_text(json.dumps(spec))
    return str(path)


def _replica_env():
    import os

    return dict(os.environ, OMP_NUM_THREADS="1")


def _reference_fn():
    from tests.test_torch_fleet_router import _reference, _tiny_model

    model, cfg = _tiny_model()
    cache = {}

    def reference(prompt, n):
        key = (tuple(prompt), n)
        if key not in cache:
            cache[key] = _reference(model, cfg, [list(prompt)], n)[0]
        return cache[key]
    return reference


@pytest.mark.slow
@pytest.mark.faults
def test_autoscaler_scales_on_firing_ttft_slo_multiprocess(tmp_path):
    """A firing TTFT rule makes the autoscaler attach a pre-spawned warm
    replica process (1 -> 2), traffic on the grown fleet equals
    ``generate()``, and after quiet and cooldown it drains back to 1 with
    the detached replica exiting ``EXIT_PREEMPTED``."""
    from deepspeed_tpu_torch.telemetry.slo import SloEngine, SloRule

    reference = _reference_fn()
    spawner = ProcessReplicaSpawner(_replica_config(tmp_path), env=_replica_env())
    router = None
    auto = None
    try:
        base = spawner.spawn("base")
        router = Router([base.endpoint()],
                        FleetConfig(enabled=True, retry_budget=3, retry_backoff_s=0.05,
                                    attempt_timeout_s=300.0, health_ttl_s=0.1,
                                    affinity_prefix_tokens=0))
        slo = SloEngine([SloRule("ttft_p95_s", max=0.2, for_s=0.0)])
        auto = Autoscaler(router, spawner,
                          AutoscaleConfig(enabled=True, min_replicas=1, max_replicas=2,
                                          warm_spares=1, up_after_s=0.05,
                                          down_after_s=0.1, cooldown_s=0.05),
                          alerts=slo, replicas=[base])
        auto.step()                         # spawns the warm spare
        assert auto.stats()["warm_spares"] == 1.0
        slo.evaluate({"ttft_p95_s": 5.0})   # over budget: fire
        deadline = time.monotonic() + 60
        while len(router.endpoints()) < 2 and time.monotonic() < deadline:
            auto.step()
            time.sleep(0.05)
        assert len(router.endpoints()) == 2, "never scaled up on firing SLO"
        assert auto.scale_ups == 1
        prompt = [3, 1, 4, 1]
        out = router.submit(prompt, max_new_tokens=6).result(timeout=600)
        assert out == reference(prompt, 6)
        attached = next(h for h in spawner._spawned
                        if h.name != "base"
                        and any(e.name == h.name for e in router.endpoints()))
        slo.evaluate({"ttft_p95_s": 0.01})  # back under budget: quiet
        deadline = time.monotonic() + 60
        while len(router.endpoints()) > 1 and time.monotonic() < deadline:
            auto.step()
            time.sleep(0.05)
        assert len(router.endpoints()) == 1, "never drained back down"
        assert auto.scale_downs == 1
        assert attached.proc.wait(timeout=120) == EXIT_PREEMPTED
        out2 = router.submit([2, 7, 1], max_new_tokens=6).result(timeout=600)
        assert out2 == reference([2, 7, 1], 6)
    finally:
        if auto is not None:
            auto.stop()
        if router is not None:
            router.close()
        spawner.stop_all()


@pytest.mark.slow
@pytest.mark.faults
def test_chaos_schedule_real_replicas_all_faults(tmp_path):
    """A seeded schedule over real replica processes forcing every fault
    kind once (kill, drain, slow, reject, overload): every completion
    equals ``generate()``, nothing is stuck, the fleet converges."""
    from tests.test_torch_fleet_router import MODEL

    reference = _reference_fn()
    spawner = ProcessReplicaSpawner(_replica_config(tmp_path, chaos=True),
                                    env=_replica_env())
    router = None
    try:
        replicas = [spawner.spawn("c0"), spawner.spawn("c1")]
        router = Router([h.endpoint() for h in replicas],
                        FleetConfig(enabled=True, retry_budget=4, retry_backoff_s=0.05,
                                    attempt_timeout_s=300.0, health_ttl_s=0.1,
                                    saturation_queue_depth=8, shed_retry_after_s=0.1,
                                    affinity_prefix_tokens=0))
        harness = ChaosHarness(router, spawner, reference, replicas, seed=3,
                               max_new_tokens=6, request_timeout_s=300.0,
                               recovery_timeout_s=300.0, vocab=MODEL["vocab_size"])
        for kind in ("slow_replica", "reject_admission", "kill_replica",
                     "drain_replica", "overload"):
            harness.run_episode(kind=kind)
        report = harness.report()
        assert report["chaos_episodes"] == 5
        assert report["invariant_bitwise_ok"], report
        assert report["invariant_no_stuck"], report
        assert report["invariant_recovery_bounded"], report
        assert report["invariant_converged"], report
        assert report["completed_total"] > 0
    finally:
        if router is not None:
            router.close()
        spawner.stop_all()
