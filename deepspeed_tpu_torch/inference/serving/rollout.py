"""Zero-downtime weight rollout: live checkpoint hot-swap with canary,
shadow traffic, and automatic rollback.

A copy of ``deepspeed_tpu/inference/serving/rollout.py`` with only the
imports rebound; the manifest is ``runtime/checkpoint/manifest.py``.
It composes checkpoint commit records, the warm-spare autoscaler pool,
router surgery and the SIGTERM drain path, driven by one supervisor-side state machine::

       idle ──new committed tag──▶ staging ──canaries attached──▶ canary
        ▲                            │                              │
        │                    boot/verify failed               soak gates met
        │                            ▼                              ▼
        │◀──fleet recovered── rolling_back ◀──regression──── promoting
        │                                                           │
        └───────────────◀─── committed ◀──incumbents drained────────┘

- **idle -> staging**: a :class:`TagWatcher` poll observes a newly
  committed manifest tag (the atomically-written commit record, so a
  torn checkpoint is invisible by construction). The tag directory is
  re-verified against its manifest before any process boots on it; a
  corrupt tag is blacklisted and the rollout never starts.
- **staging -> canary**: ``canary_replicas`` workers boot on the new
  weights — warm spares from the autoscaler pool when one is wired in,
  cold spawns otherwise — and attach to the router tagged with the new
  generation. The router then routes a deterministic
  ``canary_fraction`` slice of NEW requests onto them, chosen by the
  same prompt-prefix hash the affinity policy uses, so cache locality
  survives the split and a given prefix sticks to one side of it.
- **canary soak**: live requests completed by the incumbent are sampled
  at ``shadow_sample_rate`` and replayed against the canary over the
  replica wire protocol; outputs are diffed bitwise (greedy decode is
  deterministic per generation) and latency is tracked per request
  class. The canary must hold ``canary_hold_s``, carry
  ``min_canary_requests`` live attempts, and survive
  ``min_shadow_compared`` shadow compares before promotion.
- **promoting -> committed**: the remaining new-generation capacity
  attaches, then each incumbent leaves through the existing drain path
  (``remove_endpoint`` + SIGTERM): in-flight work finishes where it is,
  retries stay generation-pinned, and the idempotency-key oracle proves
  no request was dropped or double-completed across the swap.
- **any regression -> rolling_back**: a firing SLO alert, a shadow diff
  rate above ``shadow_diff_threshold``, or a canary crash-loop tears
  the canary down the same drain path, blacklists the tag, and the
  machine waits for the fleet to probe healthy on the incumbent
  generation — bounded by ``recovery_bound_s`` (asserted by the chaos
  harness).

Clock-injectable and single-steppable (``step(now)``) like the
autoscaler, so tests and the chaos harness drive it deterministically;
``start()`` runs the same step on a background thread. Stdlib-only: the
module itself imports no torch.
"""

import os
import random
import socket
import sys
import threading
import time
import uuid
from collections import deque

from deepspeed_tpu_torch.inference.serving.config import RolloutConfig
from deepspeed_tpu_torch.inference.serving.metrics import RolloutMetrics
from deepspeed_tpu_torch.inference.serving.router import (
    PROTOCOL_VERSION,
    _http_json,
    read_line,
    send_line,
)
from deepspeed_tpu_torch.runtime.checkpoint.manifest import (
    CheckpointCorruptionError,
    TagWatcher,
    verify_tag_dir,
)


class RolloutController:
    """Supervisor-side weight-rollout state machine over one Router.

    Parameters
    ----------
    router : Router
        The live routing front-door. The controller attaches/removes
        endpoints, sets the canary slice, and installs a completion tap
        for shadow sampling.
    spawner : ProcessReplicaSpawner (or compatible)
        Boots replicas on a weight generation (``spawn(name=...,
        generation=tag)``) and owns the SIGTERM drain (``drain``).
    watch : TagWatcher | str
        A manifest watcher, or a checkpoint save-dir root to build one
        over. New committed tags observed here trigger rollouts.
    replicas : iterable of handles
        The ALREADY-ROUTED incumbent handles (name-matched to the
        router's endpoints), so promotion can drain the processes it
        detaches — same contract as the autoscaler.
    autoscaler : Autoscaler, optional
        When wired in, canaries come from its warm-spare pool
        (``take_spares``) and its pool is retargeted on commit/rollback
        (``set_weight_tag``) so refills track the serving generation.
    alerts : optional
        SLO pressure signal for the rollback trigger: an ``/alerts``
        URL, an object with ``alerts_doc()``, or a callable returning a
        bool/doc. Unreadable = not firing (an unreachable alerts
        endpoint must not tear down a healthy canary).
    incumbent_tag : str
        Weight generation the current fleet serves (must match the
        routed endpoints' ``generation``).
    """

    def __init__(self, router, spawner, watch, config=None, replicas=(),
                 autoscaler=None, alerts=None, metrics=None, registry=None,
                 clock=time.monotonic, incumbent_tag="0", verify_deep=False,
                 rng=None):
        self.router = router
        self.spawner = spawner
        self.watcher = watch if isinstance(watch, TagWatcher) \
            else TagWatcher(str(watch))
        self.config = config or RolloutConfig(enabled=True)
        self.autoscaler = autoscaler
        self._alerts = alerts
        self.metrics = metrics or RolloutMetrics()
        self._clock = clock
        self._rng = rng or random.Random()
        self.verify_deep = bool(verify_deep)
        self.current_tag = str(incumbent_tag)
        self._lock = threading.Lock()
        self._incumbents = {h.name: h for h in replicas}
        self._canaries = {}             # name -> handle, this rollout
        self._dead_canaries = set()     # names already counted as crashed
        self._bad_tags = set()          # blacklisted (corrupt / rolled back)
        self.phase = "idle"
        self._target_tag = None
        self._canary_since = None
        self._canary_routed_base = 0
        self._boot_seq = 0
        self._rollback_started = None
        self._shadow_pending = deque(
            maxlen=max(1, self.config.shadow_max_pending))
        self._thread = None
        self._stop = threading.Event()
        if registry is not None:
            self.export_gauges(registry)

    # -- observability ----------------------------------------------------
    def status(self):
        with self._lock:
            canaries = list(self._canaries)
        return {
            "phase": self.phase,
            "current_tag": self.current_tag,
            "target_tag": self._target_tag,
            "canaries": canaries,
            "bad_tags": sorted(self._bad_tags),
            "canary_routed": self._canary_routed_delta(),
            "shadow_compared": self.metrics.shadow_compared_total,
            "shadow_diffs": self.metrics.shadow_diff_total,
            "rollbacks_total": self.metrics.rollbacks_total,
            "commits_total": self.metrics.commits_total,
        }

    def export_gauges(self, registry):
        self.metrics.export_to(registry)
        return registry

    def _set_phase(self, phase):
        self.phase = phase
        self.metrics.set_phase(phase)
        self._note("rollout/phase", phase=phase, tag=self._target_tag)

    # -- the pressure signal (same shapes the autoscaler accepts) ---------
    def _alert_firing(self):
        src = self._alerts
        if src is None:
            return False
        try:
            if isinstance(src, str):
                url = src if src.endswith("/alerts") \
                    else src.rstrip("/") + "/alerts"
                doc = _http_json(url, 2.0)
            elif hasattr(src, "alerts_doc"):
                doc = src.alerts_doc()[1]
            else:
                doc = src()
        except Exception:
            return False        # unreadable must not tear down a canary
        if isinstance(doc, bool):
            return doc
        if isinstance(doc, dict):
            return bool(doc.get("firing", 0)) \
                or doc.get("status") == "alerting"
        return bool(doc)

    # -- one control tick -------------------------------------------------
    def step(self, now=None):
        """One deterministic tick; returns the transition taken (e.g.
        "staged", "canary", "promoted", "committed", "rolled_back",
        "rejected_tag") or None when the machine held its state."""
        now = self._clock() if now is None else now
        handler = {
            "idle": self._step_idle,
            "staging": self._step_staging,
            "canary": self._step_canary,
            "promoting": self._step_promoting,
            "rolling_back": self._step_rolling_back,
            "committed": self._step_committed,
        }[self.phase]
        return handler(now)

    def _step_idle(self, now):
        observed = self.watcher.poll()
        if observed is None:
            return None
        tag, _seq = observed
        if tag == self.current_tag or tag in self._bad_tags:
            return None
        tag_dir = os.path.join(self.watcher.root, tag)
        try:
            verify_tag_dir(tag_dir, deep=self.verify_deep)
        except CheckpointCorruptionError as e:
            # never boot a replica on a tag that fails its own manifest
            self._bad_tags.add(tag)
            self._note("rollout/corrupt_tag", tag=tag, error=str(e))
            return "rejected_tag"
        self._target_tag = tag
        self._dead_canaries.clear()
        self._shadow_pending.clear()
        self.metrics.begin_rollout(tag)
        self.phase = "staging"          # begin_rollout set the gauge
        self._note("rollout/begin", tag=tag)
        return "staged"

    def _boot_canaries(self, tag, n):
        handles = []
        if self.autoscaler is not None:
            handles = self.autoscaler.take_spares(tag, n)
        while len(handles) < n:
            # names must stay unique across the staging AND promoting
            # boots of one rollout (the router refuses duplicates)
            self._boot_seq += 1
            try:
                handles.append(self.spawner.spawn(
                    name=f"canary-{tag}-{self._boot_seq}", generation=tag))
            except Exception as e:
                self._note("rollout/spawn_failed", tag=tag, error=str(e))
                break
        return handles

    def _step_staging(self, now):
        tag = self._target_tag
        handles = self._boot_canaries(tag, max(1, self.config.canary_replicas))
        if not handles:
            self._bad_tags.add(tag)
            self._target_tag = None
            self._set_phase("idle")
            self._note("rollout/abort", tag=tag, reason="canary_boot_failed")
            return "rejected_tag"
        with self._lock:
            for h in handles:
                self._canaries[h.name] = h
        for h in handles:
            self.router.add_endpoint(h.endpoint(), generation=tag)
        self._canary_routed_base = \
            self.router.counters().get("canary_routed", 0)
        self.router.set_canary(tag, self.config.canary_fraction)
        if self.config.shadow_sample_rate > 0:
            self.router.set_completion_tap(self._on_completion)
        self._canary_since = now
        self._set_phase("canary")
        return "canary"

    def _canary_routed_delta(self):
        if self._target_tag is None:
            return 0
        routed = self.router.counters().get("canary_routed", 0)
        return max(0, routed - self._canary_routed_base)

    def _regression(self):
        """First firing rollback trigger, or None."""
        cfg = self.config
        crashed = 0
        with self._lock:
            canaries = list(self._canaries.values())
        for h in canaries:
            if h.name in self._dead_canaries:
                crashed += 1
                continue
            if not h.alive():
                self._dead_canaries.add(h.name)
                self.metrics.record_canary_crash()
                crashed += 1
        if "canary_crash" in cfg.rollback_on \
                and crashed >= max(1, cfg.max_canary_crashes):
            return "canary_crash"
        if "slo_alert" in cfg.rollback_on and self._alert_firing():
            return "slo_alert"
        if ("shadow_diff" in cfg.rollback_on
                and self.metrics.shadow_compared_total
                >= max(1, cfg.min_shadow_compared)
                and self.metrics.shadow_diff_rate()
                > cfg.shadow_diff_threshold):
            return "shadow_diff"
        return None

    def _step_canary(self, now):
        self._process_shadow()
        reason = self._regression()
        if reason is not None:
            return self._begin_rollback(reason, now)
        cfg = self.config
        if now - self._canary_since < cfg.canary_hold_s:
            return None
        if self._canary_routed_delta() < cfg.min_canary_requests:
            return None
        if (cfg.shadow_sample_rate > 0
                and self.metrics.shadow_compared_total
                < cfg.min_shadow_compared):
            return None
        self._set_phase("promoting")
        return "promoting"

    def _step_promoting(self, now):
        reason = self._regression()
        if reason is not None:
            return self._begin_rollback(reason, now)
        tag = self._target_tag
        with self._lock:
            incumbents = dict(self._incumbents)
            live_canaries = sum(1 for h in self._canaries.values()
                                if h.name not in self._dead_canaries)
        # widen the slice first: every unpinned request now prefers the
        # new generation while the incumbents drain out under it
        self.router.set_canary(tag, 1.0)
        shortfall = max(0, len(incumbents) - live_canaries)
        extra = self._boot_canaries(tag, shortfall) if shortfall else []
        with self._lock:
            for h in extra:
                self._canaries[h.name] = h
        for h in extra:
            self.router.add_endpoint(h.endpoint(), generation=tag)
        # one-at-a-time handoff down the drain path: detach (nothing new
        # lands, retries are generation-pinned), then SIGTERM (finish
        # in-flight, exit EXIT_PREEMPTED)
        for name, handle in incumbents.items():
            try:
                self.router.remove_endpoint(name)
            except ValueError:
                pass            # already detached (breaker/operator)
            self.spawner.drain(handle)
            with self._lock:
                self._incumbents.pop(name, None)
        self.router.clear_canary()
        self.router.set_completion_tap(None)
        with self._lock:
            promoted, self._canaries = self._canaries, {}
            self._incumbents.update(
                (n, h) for n, h in promoted.items()
                if n not in self._dead_canaries)
        self.current_tag = tag
        self._target_tag = None
        if self.autoscaler is not None:
            self.autoscaler.set_weight_tag(tag)
        self.metrics.record_commit()
        self._set_phase("committed")
        self._note("rollout/commit", tag=tag)
        return "committed"

    def _begin_rollback(self, reason, now):
        tag = self._target_tag
        # slice off first: every NEW request routes to the incumbent
        # generation from this instant
        self.router.clear_canary()
        self.router.set_completion_tap(None)
        with self._lock:
            canaries, self._canaries = self._canaries, {}
        for name, handle in canaries.items():
            try:
                self.router.remove_endpoint(name)
            except ValueError:
                pass
            # the same SIGTERM drain path scale-down uses: in-flight
            # canary work finishes where it is, nothing is dropped
            self.spawner.drain(handle)
        self._bad_tags.add(tag)
        self._shadow_pending.clear()
        self.metrics.record_rollback(reason)
        self._rollback_started = now
        if self.autoscaler is not None:
            self.autoscaler.set_weight_tag(self.current_tag)
        self._set_phase("rolling_back")
        self._note("rollout/rollback", tag=tag, reason=reason)
        return "rolled_back"

    def _step_rolling_back(self, now):
        eps = self.router.probe_all(force=True)
        settled = all(ep.generation == self.current_tag for ep in eps) \
            and any(ep.healthy and not ep.draining for ep in eps)
        if not settled:
            return None
        self.metrics.last_recovery_s = max(0.0, now - self._rollback_started)
        self._target_tag = None
        self._set_phase("idle")
        self._note("rollout/recovered",
                   recovery_s=self.metrics.last_recovery_s)
        return "recovered"

    def _step_committed(self, now):
        self._set_phase("idle")
        return None

    # -- shadow traffic ---------------------------------------------------
    def _on_completion(self, info):
        """Router completion tap: sample incumbent answers for replay."""
        if self.phase != "canary":
            return
        if info.get("generation") != self.current_tag:
            return              # only incumbent answers are references
        if self._rng.random() >= self.config.shadow_sample_rate:
            return
        # deque(maxlen) drops the oldest sample when full: shadowing
        # never applies backpressure to live traffic
        self._shadow_pending.append(info)

    def _live_canary_endpoint(self):
        tag = self._target_tag
        for ep in self.router.endpoints():
            if ep.generation == tag and not ep.removed \
                    and ep.name not in self._dead_canaries:
                return ep
        return None

    def _process_shadow(self):
        while self._shadow_pending:
            ep = self._live_canary_endpoint()
            if ep is None:
                return
            sample = self._shadow_pending.popleft()
            replayed = self._shadow_replay(ep, sample)
            if replayed is None:
                continue        # rejection/failure: not a quality signal
            self.metrics.record_shadow(replayed == sample["tokens"])

    def _shadow_replay(self, ep, sample, timeout_s=30.0):
        """Replay one sampled request against a canary endpoint over the
        replica wire protocol. Returns the token list, or None when the
        replay was rejected or failed (crash detection owns that)."""
        want = len(sample["tokens"])
        tokens = []
        try:
            with socket.create_connection(
                    (ep.host, ep.port), timeout=timeout_s) as sock:
                sock.settimeout(timeout_s)
                send_line(sock, {
                    "op": "submit", "v": PROTOCOL_VERSION,
                    "key": "shadow-" + uuid.uuid4().hex,
                    "prompt": sample["prompt"],
                    # pin the length so a shorter/longer canary answer
                    # still diffs positionally against the reference
                    "max_new_tokens": sample["max_new_tokens"] or want,
                    "eos_token_id": sample["eos_token_id"],
                    "timeout_s": timeout_s, "from": 0})
                stream = sock.makefile("rb")
                while True:
                    doc = read_line(stream)
                    if doc is None:
                        return None
                    if "t" in doc:
                        tokens.append(int(doc["t"]))
                    elif doc.get("done"):
                        return tokens
                    elif "rejected" in doc or "error" in doc:
                        return None
        except (OSError, ValueError):
            return None

    # -- background loop --------------------------------------------------
    def start(self):
        """Run ``step()`` every ``poll_interval_s`` on a daemon thread."""
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="rollout", daemon=True)
        self._thread.start()
        return self

    def _loop(self):
        while not self._stop.is_set():
            try:
                self.step()
            except Exception:
                pass            # the control loop must not die
            self._stop.wait(self.config.poll_interval_s)

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(5.0)
            self._thread = None

    def drive(self, until=("committed",), timeout_s=120.0, tick_s=0.02):
        """Step the machine inline until the phase lands in ``until``
        (phase names, checked AFTER each step) or the deadline passes.
        Returns the final phase. For tests and the bench — production
        uses ``start()``."""
        deadline = time.monotonic() + timeout_s
        until = set(until)
        while time.monotonic() < deadline:
            self.step()
            if self.phase in until:
                return self.phase
            time.sleep(tick_s)
        return self.phase

    def _note(self, name, **args):
        if "deepspeed_tpu_torch.telemetry" not in sys.modules:
            return
        try:
            from deepspeed_tpu_torch import telemetry
            telemetry.instant(name, cat="fleet", args=args)
        except Exception:
            pass
