"""The port's zero-downtime weight rollout: canary, shadow, rollback.

The JAX package's ``tests/unit/test_rollout.py`` on the port's copies:
the ``RolloutController``, the router's generation-aware canary slice
and the rollout chaos arms against in-process stub replicas
(``tests/test_torch_fleet_router.py``), with a real checkpoint root
(``CheckpointStorage`` tag commits, the port's ``runtime/checkpoint/``)
feeding the tag watcher. Per-generation weights are stubs with salted
token functions: the same salt gives the same outputs (a clean roll
forward), another salt gives shadow diffs (a regression). Also the drain
race: ``remove_endpoint`` is visible to an attempt thread holding a stale
endpoint snapshot. In the cross-generation test the generation-1 stub
dies for good after its two tokens (its listener closes, as a dead
replica's does), so the only way on is a replay on generation 2, which
the router must refuse: the outcome does not hang on a health probe's
timing.
"""

import os
import random
import time

import pytest

from deepspeed_tpu_torch.inference.serving.chaos import RolloutChaosHarness
from deepspeed_tpu_torch.inference.serving.config import (
    FleetConfig,
    RolloutConfig,
)
from deepspeed_tpu_torch.inference.serving.metrics import RolloutMetrics
from deepspeed_tpu_torch.inference.serving.rollout import RolloutController
from deepspeed_tpu_torch.inference.serving.router import (
    ReplicaEndpoint,
    RequestPoisonedError,
    Router,
    _RoutedRequest,
)
from deepspeed_tpu_torch.runtime.checkpoint import CheckpointStorage, TagWatcher
from tests.test_torch_fleet_router import (
    FAST_CFG,
    StubReplica,
    make_router,
    stub_tokens,
    stubs,  # noqa: F401  (fixture re-export)
)


def salted_tokens(salt):
    """One weight generation's 'greedy decode': pure in the prompt,
    distinct across salts."""
    def fn(prompt, n):
        return [(sum(prompt) * 31 + salt * 101 + i * 7) % 1000
                for i in range(n)]
    return fn


def make_rr(prompt, key="k"):
    return _RoutedRequest(key, prompt, 6, None, None, None, "default",
                          len(prompt) + 6)


# ---------------------------------------------------------------------------
# drain race: a stale snapshot must never re-select a removed replica
# ---------------------------------------------------------------------------

def test_stale_snapshot_never_reselects_removed_endpoint(stubs):
    a, b = stubs(), stubs()
    r = make_router([a, b])
    stale = r.probe_all(force=True)     # snapshot taken BEFORE the remove
    removed = r.remove_endpoint("r0")
    assert removed.removed and removed.draining
    # the removed flag lives on the SHARED endpoint object, so even a
    # thread re-selecting from its pre-remove snapshot must skip it —
    # for every prompt, including ones whose affinity hash lands on r0
    for seed in range(50):
        rr = make_rr([seed + 1, 2, 3], key=f"k{seed}")
        ep = r._pick(rr, eps=stale)
        assert ep is not None and ep.name == "r1"


def test_pick_revalidates_choice_after_probe(stubs):
    a = stubs()
    r = make_router([a])
    stale = r.probe_all(force=True)
    # remove_endpoint refuses to empty the fleet; flag the object
    # directly to model the moment remove marks it inside the lock
    stale[0].removed = True
    assert r._pick(make_rr([1, 2, 3]), eps=stale) is None


# ---------------------------------------------------------------------------
# generation pinning: retries never replay across weight versions
# ---------------------------------------------------------------------------

def test_no_cross_generation_replay_poisons_instead(stubs):
    """A request that streamed tokens from generation 1 must never be
    replayed on generation 2 (different weights = different suffix =
    a silent bitwise break). Poisoning is the correct outcome."""
    a = stubs(die_after=2, token_fn=salted_tokens(1), close_on_die=True)
    b = stubs(reject="draining", reject_times=1, token_fn=salted_tokens(2))
    eps = [ReplicaEndpoint("g1", "127.0.0.1", a.port, generation="1"),
           ReplicaEndpoint("g2", "127.0.0.1", b.port, generation="2")]
    r = Router(eps, FleetConfig(enabled=True, **FAST_CFG))
    got = []
    fut = r.submit([1, 2, 3], max_new_tokens=6,
                   stream_cb=lambda k, t: got.append(t))
    with pytest.raises(RequestPoisonedError):
        fut.result(timeout=10)
    # the two delivered tokens came from generation 1, exactly once
    assert got == salted_tokens(1)([1, 2, 3], 6)[:2]
    # generation 2 never saw a replay attempt (only its initial reject
    # can appear); no submit with from>0 landed there
    assert all(frm == 0 for _, frm in b.submits)


def test_same_generation_failover_still_replays_bitwise(stubs):
    a = stubs(die_after=2)
    b = stubs()
    eps = [ReplicaEndpoint("g1a", "127.0.0.1", a.port, generation="1"),
           ReplicaEndpoint("g1b", "127.0.0.1", b.port, generation="1")]
    r = Router(eps, FleetConfig(enabled=True, **FAST_CFG))
    got = []
    for seed in range(6):
        prompt = [seed + 1, 5, 9]
        got.clear()
        toks = r.submit(prompt, max_new_tokens=6,
                        stream_cb=lambda k, t: got.append(t)).result(
                            timeout=10)
        assert toks == stub_tokens(prompt, 6) == got


# ---------------------------------------------------------------------------
# canary slice: deterministic, salted, fraction-shaped
# ---------------------------------------------------------------------------

def test_canary_slice_deterministic_and_bounded(stubs):
    a = stubs()
    r = make_router([a], affinity_prefix_tokens=4)
    rng = random.Random(7)
    prompts = [[rng.randrange(1, 99) for _ in range(5)] for _ in range(400)]
    for frac, want in ((0.0, 0), (1.0, 400)):
        assert sum(r._in_canary_slice(p, frac) for p in prompts) == want
    hits = [r._in_canary_slice(p, 0.25) for p in prompts]
    assert hits == [r._in_canary_slice(p, 0.25) for p in prompts]
    assert 0.10 < sum(hits) / len(hits) < 0.45   # ~fraction, not affinity


def test_canary_routing_splits_by_generation(stubs):
    inc = stubs(token_fn=salted_tokens(0))
    can = stubs(token_fn=salted_tokens(0))
    eps = [ReplicaEndpoint("old", "127.0.0.1", inc.port, generation="v1"),
           ReplicaEndpoint("new", "127.0.0.1", can.port, generation="v2")]
    r = Router(eps, FleetConfig(enabled=True, **FAST_CFG,
                                affinity_prefix_tokens=4))
    r.set_canary("v2", 1.0)
    for seed in range(8):
        r.submit([seed + 1, 2], max_new_tokens=6).result(timeout=10)
    assert r.counters()["canary_routed"] == 8
    assert len(inc.submits) == 0 and len(can.submits) == 8
    r.set_canary("v2", 0.0)
    for seed in range(8):
        r.submit([seed + 50, 2], max_new_tokens=6).result(timeout=10)
    assert r.counters()["canary_routed"] == 8   # unchanged
    assert len(inc.submits) == 8


# ---------------------------------------------------------------------------
# controller fixtures: fake spawner over salted stubs + a real ckpt root
# ---------------------------------------------------------------------------

class GenHandle:
    def __init__(self, name, stub, generation):
        self.name, self.host, self.port = name, "127.0.0.1", stub.port
        self.stub = stub
        self.generation = str(generation)
        self._alive = True

    def alive(self):
        return self._alive

    def endpoint(self):
        return ReplicaEndpoint(self.name, self.host, self.port,
                               generation=self.generation)


class GenFakeSpawner:
    """In-process spawner whose 'weights' are per-tag token salts."""

    def __init__(self, salt_for_tag):
        self.salt_for_tag = salt_for_tag
        self.made, self.drained, self.killed = [], [], []
        self._seq = 0

    def spawn(self, name=None, generation=None):
        self._seq += 1
        tag = "0" if generation is None else str(generation)
        stub = StubReplica(token_fn=salted_tokens(self.salt_for_tag(tag)))
        h = GenHandle(name or f"fake-{self._seq}", stub, tag)
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


def commit_tag(root, tag, payload=b'{"seed": 0}'):
    w = CheckpointStorage().tag_writer(str(root), tag)
    w.write_file("weights.json", payload)
    w.commit()


FAST_ROLLOUT = dict(
    enabled=True, canary_fraction=0.5, canary_replicas=1,
    shadow_sample_rate=1.0, canary_hold_s=0.0, min_canary_requests=1,
    min_shadow_compared=1, shadow_diff_threshold=0.0,
    max_canary_crashes=1, poll_interval_s=0.01, recovery_bound_s=10.0)


def build_fleet(tmp_path, salt_for_tag, **cfg_over):
    root = tmp_path / "ckpts"
    commit_tag(root, "v1")
    spawner = GenFakeSpawner(salt_for_tag)
    incumbents = [spawner.spawn(f"inc-{i}", generation="v1")
                  for i in range(2)]
    router = Router([h.endpoint() for h in incumbents],
                    FleetConfig(enabled=True, **FAST_CFG,
                                affinity_prefix_tokens=4))
    controller = RolloutController(
        router, spawner, str(root),
        config=RolloutConfig(**{**FAST_ROLLOUT, **cfg_over}),
        replicas=incumbents, incumbent_tag="v1", rng=random.Random(0))
    return root, spawner, router, controller


def pump_until(router, controller, done, n_req=40, timeout_s=20.0):
    """Interleave seeded traffic with controller steps until done()."""
    rng = random.Random(1)
    futs = []
    deadline = time.monotonic() + timeout_s
    i = 0
    while (i < n_req or not done()) and time.monotonic() < deadline:
        if i < n_req:
            prompt = [rng.randrange(1, 99) for _ in range(5)]
            futs.append((prompt, router.submit(
                prompt, max_new_tokens=6, shed_retries=10)))
            i += 1
        controller.step()
        time.sleep(0.002)
    return futs, done()


def settle_bitwise(futs, salts=(0,)):
    """Every future completes and matches ONE salt's tokens bitwise."""
    for prompt, fut in futs:
        toks = fut.result(timeout=10)
        assert any(toks == salted_tokens(s)(prompt, 6) for s in salts), \
            f"output for {prompt} matches no single generation"


# ---------------------------------------------------------------------------
# controller: roll-forward and rollback state machines
# ---------------------------------------------------------------------------

def test_controller_rolls_forward_on_clean_canary(tmp_path):
    root, spawner, router, c = build_fleet(tmp_path, lambda tag: 0)
    try:
        assert c.step() is None and c.phase == "idle"
        commit_tag(root, "v2")
        futs, ok = pump_until(router, c, lambda: c.current_tag == "v2")
        assert ok and c.metrics.commits_total == 1
        assert {ep.generation for ep in router.endpoints()} == {"v2"}
        # both incumbents went down the polite drain path
        assert set(spawner.drained) >= {"inc-0", "inc-1"}
        assert c.metrics.shadow_compared_total >= 1
        assert c.metrics.shadow_diff_total == 0
        assert router.counters()["canary_routed"] >= 1
        assert router.canary is None            # slice cleaned up
        settle_bitwise(futs)                    # zero dropped, bitwise
        c.drive(until=("idle",), timeout_s=5.0)
        assert c.step() is None                 # v2 not re-staged
    finally:
        router.close()
        spawner.close_all()


def test_controller_rolls_back_on_shadow_diff(tmp_path):
    root, spawner, router, c = build_fleet(
        tmp_path, lambda tag: 1 if tag == "v2" else 0,
        min_shadow_compared=2, canary_hold_s=5.0)
    try:
        commit_tag(root, "v2")                  # regressed weights
        futs, ok = pump_until(
            router, c,
            lambda: c.metrics.rollbacks_total >= 1 and c.phase == "idle")
        assert ok
        assert c.current_tag == "v1"
        assert c.metrics.last_rollback_reason == "shadow_diff"
        assert c.metrics.last_recovery_s is not None \
            and c.metrics.last_recovery_s <= 10.0
        assert {ep.generation for ep in router.endpoints()} == {"v1"}
        assert "v2" in c._bad_tags
        assert spawner.drained                  # canary drained, not killed
        assert not spawner.killed
        # the bad tag is blacklisted: the machine stays idle on it
        for _ in range(5):
            assert c.step() is None and c.phase == "idle"
        # traffic that landed on the canary matched ITS generation
        # bitwise; everything else matched the incumbents'
        settle_bitwise(futs, salts=(0, 1))
    finally:
        router.close()
        spawner.close_all()


def test_controller_rolls_back_on_slo_alert(tmp_path):
    firing = [False]
    root, spawner, router, c = build_fleet(tmp_path, lambda tag: 0,
                                           shadow_sample_rate=0.0,
                                           canary_hold_s=60.0)
    c._alerts = lambda: firing[0]
    try:
        commit_tag(root, "v2")
        assert c.step() == "staged"
        assert c.step() == "canary"
        assert c.step() is None                 # healthy canary holds
        firing[0] = True
        assert c.step() == "rolled_back"
        assert c.metrics.last_rollback_reason == "slo_alert"
        c.drive(until=("idle",), timeout_s=5.0)
        assert {ep.generation for ep in router.endpoints()} == {"v1"}
    finally:
        router.close()
        spawner.close_all()


def test_controller_rejects_corrupt_tag_before_boot(tmp_path):
    root, spawner, router, c = build_fleet(tmp_path, lambda tag: 0)
    try:
        commit_tag(root, "v2")
        # corrupt AFTER commit: inventoried file goes missing
        os.remove(os.path.join(str(root), "v2", "weights.json"))
        boots_before = len(spawner.made)
        assert c.step() == "rejected_tag"
        assert c.phase == "idle" and "v2" in c._bad_tags
        assert len(spawner.made) == boots_before    # nothing booted on it
        assert c.metrics.rollouts_total == 0        # never began
    finally:
        router.close()
        spawner.close_all()


def test_controller_status_and_gauges(tmp_path):
    from deepspeed_tpu_torch.telemetry.registry import MetricsRegistry

    root, spawner, router, c = build_fleet(tmp_path, lambda tag: 0)
    reg = MetricsRegistry()
    c.export_gauges(reg)
    try:
        st = c.status()
        assert st["phase"] == "idle" and st["current_tag"] == "v1"
        vals = reg.as_dict()
        assert vals["Rollout/phase"] == 0.0
        assert vals["Rollout/rollbacks_total"] == 0.0
        assert "Rollout/shadow_diff_total" in vals
    finally:
        router.close()
        spawner.close_all()


# ---------------------------------------------------------------------------
# chaos arms: kill-canary-mid-swap, corrupt-new-tag
# ---------------------------------------------------------------------------

def make_rollout_harness(tmp_path, seed=0):
    root, spawner, router, c = build_fleet(
        tmp_path, lambda tag: 0, canary_hold_s=60.0)
    tags = {"n": 1}

    def commit_good():
        tags["n"] += 1
        tag = f"good-{tags['n']}"
        commit_tag(root, tag)
        return tag

    def commit_corrupt():
        tags["n"] += 1
        tag = f"bad-{tags['n']}"
        commit_tag(root, tag)
        os.remove(os.path.join(str(root), tag, "weights.json"))
        return tag

    harness = RolloutChaosHarness(
        router, spawner, stub_tokens, spawner.made[:2], c,
        commit_good, commit_corrupt, seed=seed, max_new_tokens=6,
        request_timeout_s=10.0, recovery_timeout_s=10.0)
    return root, spawner, router, c, harness


def test_chaos_kill_canary_mid_swap_rolls_back_bitwise(tmp_path):
    root, spawner, router, c, harness = make_rollout_harness(tmp_path)
    try:
        rec = harness.run_episode("kill_canary_mid_swap")
        assert rec["rollout_ok"], rec
        assert rec["victim"] is not None and rec["victim"] in spawner.killed
        assert rec["bitwise_mismatch"] == 0 and rec["stuck"] == 0
        assert c.metrics.last_rollback_reason == "canary_crash"
        assert c.phase == "idle" and c.current_tag == "v1"
        rep = harness.report()
        assert rep["invariant_rollout_ok"] and rep["invariant_bitwise_ok"]
        assert rep["rollbacks_total"] == 1
    finally:
        router.close()
        spawner.close_all()


def test_chaos_corrupt_tag_never_boots_or_routes(tmp_path):
    root, spawner, router, c, harness = make_rollout_harness(tmp_path)
    try:
        boots_before = len(spawner.made)
        rec = harness.run_episode("corrupt_new_tag")
        assert rec["rollout_ok"], rec
        assert len(spawner.made) == boots_before
        assert rec["bitwise_mismatch"] == 0 and rec["stuck"] == 0
        assert all(ep.generation == "v1" for ep in router.endpoints())
    finally:
        router.close()
        spawner.close_all()


def test_chaos_rollout_schedule_composes(tmp_path):
    """A short seeded schedule mixing both rollout arms holds every
    invariant — the exactly-once bar survives repeated swaps."""
    root, spawner, router, c, harness = make_rollout_harness(tmp_path,
                                                             seed=3)
    try:
        for _ in range(4):
            harness.run_episode()
        rep = harness.report()
        assert rep["invariant_rollout_ok"], rep["episodes"]
        assert rep["invariant_bitwise_ok"] and rep["invariant_no_stuck"]
    finally:
        router.close()
        spawner.close_all()


# ---------------------------------------------------------------------------
# metrics: per-rollout counters reset, lifetime counters survive
# ---------------------------------------------------------------------------

def test_rollout_metrics_reset_across_consecutive_rollouts():
    from deepspeed_tpu_torch.telemetry.registry import MetricsRegistry

    m = RolloutMetrics()
    reg = MetricsRegistry()
    m.export_to(reg)

    m.begin_rollout("v2")
    m.record_shadow(matched=False)
    m.record_shadow(matched=True)
    m.record_canary_crash()
    m.record_rollback("shadow_diff")
    assert m.shadow_compared_total == 2 and m.shadow_diff_total == 1
    assert reg.as_dict()["Rollout/shadow_diff_total"] == 1.0

    m.begin_rollout("v3")           # the next rollout starts CLEAN
    assert m.shadow_compared_total == 0 and m.shadow_diff_total == 0
    assert m.canary_crashes == 0
    assert m.shadow_diff_rate() == 0.0
    # lifetime counters survive the reset
    assert m.rollouts_total == 2 and m.rollbacks_total == 1
    vals = reg.as_dict()
    assert vals["Rollout/shadow_diff_total"] == 0.0
    assert vals["Rollout/rollbacks_total"] == 1.0

    m.record_commit()
    assert m.commits_total == 1
    snap = m.snapshot()
    assert snap["rollouts_total"] == 2.0 and snap["commits_total"] == 1.0


# ---------------------------------------------------------------------------
# tag watcher wiring (checkpoint-side unit tests live in
# test_checkpointing.py; this covers the controller-facing contract)
# ---------------------------------------------------------------------------

def test_tag_watcher_sees_commit_and_rollback(tmp_path):
    root = tmp_path / "ckpts"
    w = TagWatcher(str(root))           # constructed over an empty root
    assert w.poll() is None
    commit_tag(root, "a")
    assert w.poll() == ("a", 1)
    assert w.poll() is None             # exactly once per change
    commit_tag(root, "b")
    assert w.poll() == ("b", 2)
    # operator rollback: deleting the newest manifest regresses latest
    os.remove(os.path.join(str(root), "b", "manifest.json"))
    assert w.poll() == ("a", 1)
    assert w.poll() is None
