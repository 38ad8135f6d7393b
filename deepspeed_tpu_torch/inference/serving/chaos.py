"""Randomized chaos harness for the serving fleet.

A copy of ``deepspeed_tpu/inference/serving/chaos.py`` with only the
imports rebound.

The fleet tier accumulated a lot of robustness machinery — failover with
exactly-once replay, drain-aware routing, retry budgets, overload
shedding, crash-loop breakers, the degrade ladder, the autoscaler — each
tested in isolation. This harness tests the COMPOSITION: a seeded
randomized schedule of fault episodes against a LIVE router + replica
fleet, with the paper's correctness bar asserted after every single
episode, not just at the end:

- **exactly-once, bitwise**: every request that completes must return
  tokens bitwise-identical to the single-engine ``generate()`` oracle
  (greedy decoding is deterministic, so any divergence means a replay
  bug, a duplicated token, or cross-replica state leakage).
- **no stuck requests**: every submitted request reaches a terminal
  state — tokens, a structured error, or a shed — within a deadline.
  A future that never resolves is the worst serving failure mode.
- **bounded recovery**: after each fault clears, the time until the
  fleet is healthy again (every routed endpoint probing healthy AND a
  canary request completing) is measured and bounded.
- **convergence**: after the full schedule the fleet must walk itself
  back to normal — degrade rung 0, no draining endpoints, all healthy.

Fault kinds composed by the schedule (all five can interleave across
episodes; seeds make any failure replayable):

===================  ====================================================
``kill_replica``     SIGKILL a routed replica mid-traffic (hard death —
                     no drain, no flush), then respawn and re-attach.
``drain_replica``    SIGTERM (the polite path): replica finishes
                     in-flight work, exits ``EXIT_PREEMPTED``; respawn.
``slow_replica``     arm the ``slow_replica`` fault point over the
                     socket ``inject`` op: every reply delayed.
``reject_admission`` arm ``reject_admission``: the replica bounces new
                     keys, forcing the router's free re-route path.
``overload``         submit a burst past the fleet's saturation budget;
                     shed requests must carry ``retry_after_s`` and
                     succeed on honored re-admission.
===================  ====================================================

The harness is transport-real (subprocess replicas over TCP via
:class:`ProcessReplicaSpawner`) but fleet-shape-agnostic: tests can also
hand it an in-process fake spawner. Stdlib-only, like everything else
on the router side of the fleet.
"""

import random
import statistics
import time

from deepspeed_tpu_torch.inference.serving.autoscaler import replica_op
from deepspeed_tpu_torch.inference.serving.router import (
    FleetOverloadError,
    RequestPoisonedError,
)

FAULT_KINDS = ("kill_replica", "drain_replica", "slow_replica",
               "reject_admission", "overload")


def default_make_prompt(rng, vocab=100):
    """Deterministic-from-seed prompt generator (token 0 avoided: some
    models reserve it)."""
    n = rng.randint(3, 10)
    return [rng.randint(1, vocab - 1) for _ in range(n)]


class ChaosReport(dict):
    """Schedule results: per-episode records + the rollup the bench
    gate consumes (``chaos_episodes`` is the artifact-kind marker)."""

    @property
    def ok(self):
        return (self["invariant_bitwise_ok"] and self["invariant_no_stuck"]
                and self["invariant_recovery_bounded"]
                and self["invariant_converged"])


class ChaosHarness:
    """Drive one seeded fault schedule against a live fleet.

    ``reference_fn(prompt, max_new_tokens) -> list[int]`` is the bitwise
    oracle (single-engine ``generate()`` precomputed in-process, or the
    stub token function in router unit tests). ``replicas`` maps the
    router's endpoint names to :class:`SpawnedReplica`-shaped handles so
    faults can kill/drain/respawn the actual processes."""

    def __init__(self, router, spawner, reference_fn, replicas,
                 seed=0, faults=FAULT_KINDS, make_prompt=None,
                 max_new_tokens=8, request_timeout_s=60.0,
                 recovery_timeout_s=60.0, vocab=100):
        self.router = router
        self.spawner = spawner
        self.reference_fn = reference_fn
        self._replicas = {h.name: h for h in replicas}
        self.seed = int(seed)
        self.rng = random.Random(self.seed)
        self.faults = tuple(faults)
        unknown = set(self.faults) - set(FAULT_KINDS)
        if unknown:
            raise ValueError(f"unknown fault kinds: {sorted(unknown)}")
        self.make_prompt = make_prompt or (
            lambda rng: default_make_prompt(rng, vocab))
        self.max_new_tokens = int(max_new_tokens)
        self.request_timeout_s = float(request_timeout_s)
        self.recovery_timeout_s = float(recovery_timeout_s)
        self.episodes = []
        self._respawn_seq = 0

    # -- request plumbing ------------------------------------------------
    def _submit_batch(self, count, shed_retries=0):
        """Submit ``count`` seeded requests; returns [(prompt, future)].
        A synchronous shed (overload episodes with retries exhausted)
        records as a None future — shed is a legal terminal state, not a
        stuck request."""
        out = []
        for _ in range(count):
            prompt = self.make_prompt(self.rng)
            try:
                fut = self.router.submit(
                    prompt, max_new_tokens=self.max_new_tokens,
                    shed_retries=shed_retries)
            except FleetOverloadError:
                fut = None
            out.append((prompt, fut))
        return out

    def _collect(self, batch, record):
        """Resolve every future; folds outcomes into the episode record.
        Completions are checked bitwise against the oracle; structured
        terminal errors (poisoned, shed) are legal; a TimeoutError from
        the future itself is a STUCK request — the invariant killer."""
        deadline = time.monotonic() + self.request_timeout_s
        for prompt, fut in batch:
            if fut is None:
                record["shed"] += 1
                continue
            try:
                tokens = fut.result(
                    timeout=max(0.1, deadline - time.monotonic()))
            except TimeoutError:
                record["stuck"] += 1
                continue
            except (RequestPoisonedError, FleetOverloadError):
                record["errors"] += 1
                continue
            except Exception:
                record["errors"] += 1
                continue
            record["completed"] += 1
            expect = self.reference_fn(prompt, self.max_new_tokens)
            if list(tokens) != list(expect):
                record["bitwise_mismatch"] += 1

    # -- fault application -----------------------------------------------
    def _routed_handles(self):
        names = {ep.name for ep in self.router.endpoints()}
        return [h for n, h in self._replicas.items() if n in names]

    def _respawn(self, old):
        """Replace a dead/drained replica: spawn a fresh process and
        attach it (the autoscaler's attach path, exercised under fire)."""
        self._respawn_seq += 1
        handle = self.spawner.spawn(f"{old.name}.r{self._respawn_seq}")
        self._replicas.pop(old.name, None)
        self._replicas[handle.name] = handle
        self.router.add_endpoint(handle.endpoint())
        return handle

    def _apply_fault(self, kind, record):
        """Arm/execute one fault; returns a ``clear()`` callable that
        undoes it (respawn, disarm) — recovery timing starts after."""
        handles = self._routed_handles()
        if kind in ("kill_replica", "drain_replica") and len(handles) > 1:
            victim = self.rng.choice(handles)
            record["victim"] = victim.name
            if kind == "kill_replica":
                self.spawner.kill(victim)
            else:
                self.spawner.drain(victim, wait_s=self.request_timeout_s)

            def clear(victim=victim):
                try:
                    self.router.remove_endpoint(victim.name)
                except ValueError:
                    pass
                self._respawn(victim)
            return clear
        if kind in ("slow_replica", "reject_admission") and handles:
            victim = self.rng.choice(handles)
            record["victim"] = victim.name
            args = {"op": "inject", "point": kind}
            if kind == "slow_replica":
                args["seconds"] = round(self.rng.uniform(0.05, 0.2), 3)
                args["times"] = self.rng.randint(2, 6)
            else:
                args["times"] = self.rng.randint(1, 4)
            try:
                replica_op(victim.host, victim.port, args)
            except OSError:
                record["inject_failed"] = True

            def clear(victim=victim):
                try:
                    replica_op(victim.host, victim.port,
                               {"op": "inject", "point": None})
                except OSError:
                    pass
            return clear
        # overload (or a degenerate fleet): the fault IS extra traffic
        record["victim"] = None
        burst = self._submit_batch(
            self.rng.randint(4, 8),
            shed_retries=3)             # honor retry_after_s on re-admission
        self._collect(burst, record)
        return lambda: None

    # -- recovery --------------------------------------------------------
    def _await_recovery(self, record):
        """Time from fault-clear until the fleet is demonstrably healthy:
        every routed endpoint probes healthy and non-draining, and one
        canary request completes bitwise-correct."""
        t0 = time.monotonic()
        deadline = t0 + self.recovery_timeout_s
        while time.monotonic() < deadline:
            eps = self.router.probe_all(force=True)
            if all(ep.healthy and not ep.draining for ep in eps):
                break
            time.sleep(0.02)
        else:
            record["recovered"] = False
            record["recovery_s"] = time.monotonic() - t0
            return
        canary = self.make_prompt(self.rng)
        try:
            tokens = self.router.submit(
                canary, max_new_tokens=self.max_new_tokens,
                shed_retries=5).result(
                    timeout=max(0.1, deadline - time.monotonic()))
            record["recovered"] = (
                list(tokens) == list(self.reference_fn(
                    canary, self.max_new_tokens)))
        except Exception:
            record["recovered"] = False
        record["recovery_s"] = time.monotonic() - t0

    # -- the schedule ----------------------------------------------------
    def run_episode(self, kind=None):
        """One episode: traffic before, fault during, traffic after,
        collect, clear, time recovery. Returns the episode record."""
        kind = kind or self.rng.choice(self.faults)
        record = {"kind": kind, "completed": 0, "shed": 0, "errors": 0,
                  "stuck": 0, "bitwise_mismatch": 0}
        before = self._submit_batch(self.rng.randint(1, 3))
        clear = self._apply_fault(kind, record)
        during = self._submit_batch(self.rng.randint(1, 3),
                                    shed_retries=3)
        self._collect(before, record)
        self._collect(during, record)
        clear()
        self._await_recovery(record)
        self.episodes.append(record)
        return record

    def run(self, episodes=20):
        """The full seeded schedule; returns a :class:`ChaosReport`."""
        for _ in range(int(episodes)):
            self.run_episode()
        return self.report()

    def report(self):
        eps = self.episodes
        recoveries = sorted(e["recovery_s"] for e in eps
                            if "recovery_s" in e)
        converged = self._converged()

        def pctl(p):
            if not recoveries:
                return 0.0
            return float(recoveries[min(len(recoveries) - 1,
                                        int(p * len(recoveries)))])

        return ChaosReport({
            "chaos_episodes": len(eps),
            "chaos_seed": self.seed,
            "completed_total": sum(e["completed"] for e in eps),
            "shed_total": sum(e["shed"] for e in eps),
            "errors_total": sum(e["errors"] for e in eps),
            "recovery_p50_s": round(
                statistics.median(recoveries), 4) if recoveries else 0.0,
            "recovery_p95_s": round(pctl(0.95), 4),
            "recovery_max_s": round(
                max(recoveries), 4) if recoveries else 0.0,
            "invariant_bitwise_ok": all(
                e["bitwise_mismatch"] == 0 for e in eps),
            "invariant_no_stuck": all(e["stuck"] == 0 for e in eps),
            "invariant_recovery_bounded": all(
                e.get("recovered", False) for e in eps),
            "invariant_converged": converged,
            "episodes": [dict(e) for e in eps],
        })

    def _converged(self):
        """Post-schedule convergence: healthy fleet, ladder back at 0."""
        eps = self.router.probe_all(force=True)
        healthy = all(ep.healthy and not ep.draining for ep in eps)
        return bool(healthy and self.router.degrade_rung == 0)


DISAGG_FAULT_KINDS = ("kill_prefill_mid_handoff", "kill_decode_post_ack",
                      "corrupt_handoff_frame")

# which serving fault point each disagg episode arms on its victim
_DISAGG_POINTS = {
    "kill_prefill_mid_handoff": "handoff_kill_mid_transfer",
    "kill_decode_post_ack": "handoff_kill_post_ack",
    "corrupt_handoff_frame": "handoff_corrupt_frame",
}


class DisaggChaosHarness(ChaosHarness):
    """Chaos arms for disaggregated prefill/decode serving, on top of
    the base invariants (bitwise exactly-once, no stuck, bounded
    recovery, convergence) plus one of its own — **zero orphaned KV
    pages**: after every episode each replica's pool occupancy returns
    to zero in-use and its handoff receiver holds no pending claims.

    ``kill_prefill_mid_handoff``
        Arm ``handoff_kill_mid_transfer`` on a prefill worker: it dies
        after writing one page frame of a transfer. The router sees the
        hop-1 EOF and re-routes plain; the decode side's half-fed claim
        must be TTL-reaped (run with short ``claim_ttl_s`` so the
        zero-orphan check can observe it).
    ``kill_decode_post_ack``
        Arm ``handoff_kill_post_ack`` on a decode worker: it dies right
        after acking a transfer. The prefill side reports
        ``handoff_done``, hop 2 fails to connect, and the router replays
        plain from its delivered high-water mark — bitwise.
    ``corrupt_handoff_frame``
        Arm ``handoff_corrupt_frame`` on a prefill worker: one page
        frame is bit-flipped after its crc was computed. The receiver's
        crc check rejects it, the claim survives, and the sender's
        bounded retry lands the transfer — nobody dies.

    Lethal episodes respawn the victim **role-preserving** (a decode
    worker comes back as a decode worker) so the fleet topology the
    router scaled for survives the schedule."""

    def __init__(self, router, spawner, reference_fn, replicas, seed=0,
                 faults=DISAGG_FAULT_KINDS, **kw):
        super().__init__(router, spawner, reference_fn, replicas,
                         seed=seed, faults=(), **kw)
        self.faults = tuple(faults)
        unknown = set(self.faults) - set(FAULT_KINDS + DISAGG_FAULT_KINDS)
        if unknown:
            raise ValueError(f"unknown fault kinds: {sorted(unknown)}")

    def _handles_by_role(self, role):
        return [h for h in self._routed_handles()
                if getattr(h, "role", "mixed") == role]

    def _respawn(self, old):
        """Role-preserving respawn: the replacement worker keeps the
        victim's disaggregation role."""
        self._respawn_seq += 1
        handle = self.spawner.spawn(
            f"{old.name}.r{self._respawn_seq}",
            role=getattr(old, "role", None))
        self._replicas.pop(old.name, None)
        self._replicas[handle.name] = handle
        self.router.add_endpoint(handle.endpoint())
        return handle

    def run_episode(self, kind=None):
        kind = kind or self.rng.choice(self.faults)
        if kind not in DISAGG_FAULT_KINDS:
            return super().run_episode(kind)
        record = {"kind": kind, "completed": 0, "shed": 0, "errors": 0,
                  "stuck": 0, "bitwise_mismatch": 0}
        role = "decode" if kind == "kill_decode_post_ack" else "prefill"
        victims = self._handles_by_role(role)
        if not victims:
            # a degenerate fleet (pool scaled to zero): the episode
            # degrades to pure traffic — still invariant-checked
            record["victim"] = None
            self._collect(self._submit_batch(self.rng.randint(2, 4),
                                             shed_retries=3), record)
            record["pages_clean"] = self._pages_clean()
            self.episodes.append(record)
            return record
        victim = self.rng.choice(victims)
        record["victim"] = victim.name
        args = {"op": "inject", "point": _DISAGG_POINTS[kind], "times": 1}
        if kind == "kill_prefill_mid_handoff":
            args["at_step"] = 1         # die after the first page frame
        try:
            replica_op(victim.host, victim.port, args)
        except OSError:
            record["inject_failed"] = True
        # traffic while the arm is live: some of these requests cross the
        # victim and trip the fault mid-handoff
        during = self._submit_batch(self.rng.randint(2, 4), shed_retries=3)
        lethal = kind != "corrupt_handoff_frame"
        if lethal:
            # the kill fires only when a handoff actually crosses the
            # victim; give it a window, then respawn role-preserving so
            # in-flight retries have somewhere to land
            deadline = time.monotonic() + self.request_timeout_s / 4.0
            while victim.alive() and time.monotonic() < deadline:
                time.sleep(0.02)
            record["fired"] = not victim.alive()
            if record["fired"]:
                try:
                    self.router.remove_endpoint(victim.name)
                except ValueError:
                    pass
                self._respawn(victim)
        if not lethal or not record.get("fired"):
            try:                        # disarm a survivor: a stale arm
                replica_op(victim.host, victim.port,   # must not leak into
                           {"op": "inject", "point": None})  # later episodes
            except OSError:
                pass
        self._collect(during, record)
        self._await_recovery(record)
        record["pages_clean"] = self._pages_clean()
        self.episodes.append(record)
        return record

    def _pages_clean(self, timeout_s=None):
        """The zero-orphan invariant: poll every routed replica's health
        until its KV pool shows zero lanes in use and its handoff
        receiver zero pending claims. Polling IS the reaper heartbeat
        (the receiver reaps on every health probe), so an orphaned claim
        clears as soon as its TTL expires."""
        deadline = time.monotonic() + (
            self.recovery_timeout_s if timeout_s is None else timeout_s)
        while time.monotonic() < deadline:
            clean = True
            for ep in self.router.endpoints():
                try:
                    doc = replica_op(ep.host, ep.port, {"op": "health"})
                except OSError:
                    clean = False
                    break
                pool = doc.get("kv_pool") or {}
                if int(pool.get("in_use", 0)) != 0 \
                        or int(doc.get("handoff_pending", 0)) != 0:
                    clean = False
                    break
            if clean:
                return True
            time.sleep(0.05)
        return False

    def report(self):
        rep = super().report()
        disagg = [e for e in self.episodes
                  if e["kind"] in DISAGG_FAULT_KINDS]
        rep["disagg_episodes"] = len(disagg)
        rep["handoff_faults_fired"] = sum(
            1 for e in disagg if e.get("fired"))
        rep["invariant_pages_clean"] = all(
            e.get("pages_clean", True) for e in self.episodes)
        return rep


MEMTIER_FAULT_KINDS = ("corrupt_spill_entry", "torn_spill_write",
                       "host_mem_pressure")


class MemtierChaosHarness(ChaosHarness):
    """Chaos arms for the prefix-cache memory tier (spill store +
    pressure guard), on top of the base invariants (bitwise
    exactly-once, no stuck, bounded recovery, convergence) plus one of
    its own — **spill faults are invisible**: a corrupt blob, a torn
    disk write, or a memory-pressure escalation may cost a re-prefill,
    but must never error, stall, or bitwise-perturb a single request.

    ``corrupt_spill_entry``
        Flip a byte in a spilled prefix blob on a live replica. The next
        promotion of that entry must fail its crc32, drop the record,
        and fall through to a normal suffix prefill.
    ``torn_spill_write``
        The victim's next spill-to-disk writes land truncated under
        their final names (a crash mid-write without the atomic rename
        discipline). The framed reload must reject them on promotion.
    ``host_mem_pressure``
        The victim's ``MemoryPressureGuard`` reads a fake
        over-watermark RSS for several checks, walking
        shed-spill -> pause-inserts -> degrade-rung under live traffic;
        with the arm exhausted the guard (and ladder) must recover.

    Traffic is steered through a small pool of SHARED prompt prefixes
    (``shared_prefix_frac``) so the prefix cache — and therefore its
    spill tier — actually carries state worth corrupting; the rest stays
    fully random like the base harness. All three arms are non-lethal:
    episodes arm over the socket ``inject`` op and disarm after."""

    def __init__(self, router, spawner, reference_fn, replicas, seed=0,
                 faults=MEMTIER_FAULT_KINDS, shared_prefix_len=6,
                 shared_prefix_frac=0.7, vocab=100, **kw):
        super().__init__(router, spawner, reference_fn, replicas,
                         seed=seed, faults=(), vocab=vocab, **kw)
        self.faults = tuple(faults)
        unknown = set(self.faults) - set(FAULT_KINDS + MEMTIER_FAULT_KINDS)
        if unknown:
            raise ValueError(f"unknown fault kinds: {sorted(unknown)}")
        self.shared_prefix_frac = float(shared_prefix_frac)
        # a couple of fixed bases, seeded: enough to force live-tier
        # eviction (hence demotion) without every prompt colliding
        self._bases = [[self.rng.randint(1, vocab - 1)
                        for _ in range(int(shared_prefix_len))]
                       for _ in range(3)]
        self.make_prompt = self._memtier_prompt

    def _memtier_prompt(self, rng):
        if rng.random() < self.shared_prefix_frac:
            base = rng.choice(self._bases)
            tail = [rng.randint(1, 99) for _ in range(rng.randint(1, 3))]
            return list(base) + tail
        return default_make_prompt(rng)

    def _victim_spill_stats(self, victim):
        """Cumulative spill counters from the victim's health doc, {}
        when unreachable or spill-less."""
        try:
            doc = replica_op(victim.host, victim.port, {"op": "health"})
        except OSError:
            return {}
        spill = (doc.get("prefix_cache") or {}).get("spill") or {}
        return {k: int(spill.get(k, 0))
                for k in ("demotions", "promotions", "corrupt_dropped")}

    def run_episode(self, kind=None):
        kind = kind or self.rng.choice(self.faults)
        if kind not in MEMTIER_FAULT_KINDS:
            return super().run_episode(kind)
        record = {"kind": kind, "completed": 0, "shed": 0, "errors": 0,
                  "stuck": 0, "bitwise_mismatch": 0}
        handles = self._routed_handles()
        if not handles:
            record["victim"] = None
            self._collect(self._submit_batch(self.rng.randint(2, 4),
                                             shed_retries=3), record)
            self.episodes.append(record)
            return record
        victim = self.rng.choice(handles)
        record["victim"] = victim.name
        spill_before = self._victim_spill_stats(victim)
        # warm traffic FIRST: the spill tier needs demoted state before
        # corrupting/tearing it means anything
        before = self._submit_batch(self.rng.randint(2, 4))
        self._collect(before, record)
        args = {"op": "inject", "point": kind}
        if kind == "host_mem_pressure":
            args["times"] = self.rng.randint(4, 8)  # pressured guard ticks
        else:
            args["times"] = self.rng.randint(1, 3)
        try:
            replica_op(victim.host, victim.port, args)
        except OSError:
            record["inject_failed"] = True
        during = self._submit_batch(self.rng.randint(2, 4), shed_retries=3)
        self._collect(during, record)
        try:                            # a stale arm must not leak into
            replica_op(victim.host, victim.port,     # later episodes
                       {"op": "inject", "point": None})
        except OSError:
            pass
        self._await_recovery(record)
        spill_after = self._victim_spill_stats(victim)
        record["spill_delta"] = {
            k: spill_after.get(k, 0) - spill_before.get(k, 0)
            for k in spill_after}
        self.episodes.append(record)
        return record

    def report(self):
        rep = super().report()
        mem = [e for e in self.episodes if e["kind"] in MEMTIER_FAULT_KINDS]
        rep["memtier_episodes"] = len(mem)
        rep["spill_corrupt_dropped_total"] = sum(
            e.get("spill_delta", {}).get("corrupt_dropped", 0) for e in mem)
        rep["spill_demotions_total"] = sum(
            e.get("spill_delta", {}).get("demotions", 0) for e in mem)
        # the tentpole's bar: a spill fault may cost a re-prefill, never
        # an errored or stuck request (bitwise is already asserted base)
        rep["invariant_spill_clean"] = all(
            e["errors"] == 0 and e["stuck"] == 0 for e in mem)
        return rep


ROLLOUT_FAULT_KINDS = ("kill_canary_mid_swap", "corrupt_new_tag")


class RolloutChaosHarness(ChaosHarness):
    """Chaos arms for the weight-rollout state machine
    (inference/serving/rollout.py), on top of the base harness's
    invariants (bitwise exactly-once, no stuck, bounded recovery,
    convergence):

    ``kill_canary_mid_swap``
        Commit a good tag, drive the controller into its canary phase
        under live traffic, then SIGKILL a canary replica. The
        controller must detect the crash-loop, roll back down the drain
        path, and the fleet must recover on the incumbent generation —
        with every completed request still bitwise-correct.
    ``corrupt_new_tag``
        Commit a tag that fails manifest verification. The controller
        must refuse it before any process boots on it: the machine never
        leaves idle for that tag, no endpoint ever carries its
        generation, and live traffic is untouched.

    ``commit_good_tag()`` / ``commit_corrupt_tag()`` are injected
    callables returning a fresh tag name — the test/bench owns the
    checkpoint root and how "corrupt" is produced (torn shard, bad
    digest). The controller must be constructed over the same root and
    is stepped inline (not on its background thread) so every episode
    is deterministic from the seed."""

    def __init__(self, router, spawner, reference_fn, replicas, controller,
                 commit_good_tag, commit_corrupt_tag, seed=0,
                 faults=ROLLOUT_FAULT_KINDS, **kw):
        super().__init__(router, spawner, reference_fn, replicas,
                         seed=seed, faults=(), **kw)
        self.controller = controller
        self.commit_good_tag = commit_good_tag
        self.commit_corrupt_tag = commit_corrupt_tag
        self.faults = tuple(faults)
        unknown = set(self.faults) - set(FAULT_KINDS + ROLLOUT_FAULT_KINDS)
        if unknown:
            raise ValueError(f"unknown fault kinds: {sorted(unknown)}")

    def _drive_controller(self, until, timeout_s=30.0):
        """Step the controller inline until its phase lands in ``until``
        (or the deadline passes); returns the final phase."""
        deadline = time.monotonic() + timeout_s
        until = set(until)
        while time.monotonic() < deadline:
            self.controller.step()
            if self.controller.phase in until:
                break
            time.sleep(0.01)
        return self.controller.phase

    def run_episode(self, kind=None):
        kind = kind or self.rng.choice(self.faults)
        if kind not in ROLLOUT_FAULT_KINDS:
            return super().run_episode(kind)
        record = {"kind": kind, "completed": 0, "shed": 0, "errors": 0,
                  "stuck": 0, "bitwise_mismatch": 0}
        if kind == "kill_canary_mid_swap":
            self._episode_kill_canary(record)
        else:
            self._episode_corrupt_tag(record)
        self._await_recovery(record)
        self.episodes.append(record)
        return record

    def _episode_kill_canary(self, record):
        c = self.controller
        tag = self.commit_good_tag()
        record["tag"] = tag
        before = self._submit_batch(self.rng.randint(1, 3))
        phase = self._drive_controller(("canary",),
                                       timeout_s=self.recovery_timeout_s)
        if phase != "canary":
            record["rollout_ok"] = False
            record["victim"] = None
            self._collect(before, record)
            return
        with c._lock:
            canaries = [h for h in c._canaries.values() if h.alive()]
        victim = self.rng.choice(canaries) if canaries else None
        record["victim"] = victim.name if victim else None
        if victim is not None:
            self.spawner.kill(victim)   # hard death mid-swap: no drain
        during = self._submit_batch(self.rng.randint(1, 3), shed_retries=3)
        # the controller must notice the crash-loop and walk the machine
        # back to idle through rolling_back
        phase = self._drive_controller(("idle",),
                                       timeout_s=self.recovery_timeout_s)
        self._collect(before, record)
        self._collect(during, record)
        eps = self.router.endpoints()
        record["rollout_ok"] = (
            phase == "idle"
            and c.metrics.last_rollback_reason == "canary_crash"
            and all(ep.generation == c.current_tag for ep in eps))

    def _episode_corrupt_tag(self, record):
        c = self.controller
        tag = self.commit_corrupt_tag()
        record["tag"] = tag
        record["victim"] = None
        before = self._submit_batch(self.rng.randint(1, 3))
        # give the watcher several polls: the tag must be rejected (valid
        # manifest, corrupt payload) or never observed (torn manifest)
        deadline = time.monotonic() + 2.0
        while time.monotonic() < deadline and c.phase == "idle" \
                and tag not in c._bad_tags:
            c.step()
            time.sleep(0.01)
        during = self._submit_batch(self.rng.randint(1, 3), shed_retries=3)
        self._drive_controller(("idle",), timeout_s=self.recovery_timeout_s)
        self._collect(before, record)
        self._collect(during, record)
        eps = self.router.endpoints()
        record["rollout_ok"] = (
            c.current_tag != tag
            and all(ep.generation != tag for ep in eps))

    def report(self):
        rep = super().report()
        rep["invariant_rollout_ok"] = all(
            e.get("rollout_ok", True) for e in self.episodes)
        rep["rollbacks_total"] = self.controller.metrics.rollbacks_total
        return rep
