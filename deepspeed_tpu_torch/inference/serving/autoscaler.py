"""SLO-driven fleet autoscaler: the self-healing control loop.

A copy of ``deepspeed_tpu/inference/serving/autoscaler.py`` with only
the imports rebound (spawned replicas run this package's
``replica.py``).

Telemetry gives the fleet *observability* — the collector's ``Fleet/*``
rollups and the SLO engine's ``/alerts`` endpoint (503 while any rule
fires) — but leaves acting on those signals to a human. This module closes
the loop with a deliberately boring, stdlib-only controller:

- **scale UP on a firing SLO**: an alert (e.g. TTFT p95 over budget)
  sustained for ``up_after_s`` attaches one more replica to the
  :class:`Router`. Scale-up is *attach-not-cold-start*: a warm-spare
  pool of pre-spawned replica processes (already listening, params
  initialized, decode program compiled on first request) means the
  attach itself is O(1) — the cold-start cost was paid in the
  background, off the latency path. The pool refills after every
  attach.
- **scale DOWN after quiet**: ``down_after_s`` of alert silence (plus
  the global ``cooldown_s`` flap damper) detaches one replica and
  SIGTERMs it — the replica's drain sequence finishes in-flight work
  and exits ``EXIT_PREEMPTED`` (replica.py's SIGTERM contract), so
  scale-down never drops a request.
- **degrade instead of thrash at the ceiling**: sustained pressure with
  the fleet already at ``max_replicas`` has no capacity answer, so the
  controller escalates the fleet's :class:`DegradeLadder` instead —
  pushing the rung to the router (rung 3 = class shedding at the door)
  and to every replica over the socket ``degrade`` op (rung 1 = spec
  off, rung 2 = budget shrink). Recovery is the ladder's own
  rung-by-rung descent once pressure clears.
- **hysteresis everywhere**: ``up_after_s`` / ``down_after_s`` arm-time
  thresholds plus ``cooldown_s`` between ANY two actions keep a noisy
  alert from flapping the fleet.

The controller is clock-injectable and single-steppable (``step(now)``)
so tests and the chaos harness drive it deterministically; ``start()``
runs the same step on a background thread for real deployments.

Stdlib-only like the router: the module itself imports no torch.
"""

import json
import os
import subprocess
import sys
import threading
import time

from dataclasses import replace as _dc_replace

from deepspeed_tpu_torch.inference.serving.config import (
    AutoscaleConfig,
    RolesConfig,
)
from deepspeed_tpu_torch.inference.serving.degrade import DegradeLadder, MAX_RUNG
from deepspeed_tpu_torch.inference.serving.router import (
    ReplicaEndpoint,
    _http_json,
    read_line,
    send_line,
)
import socket as _socket


def replica_op(host, port, doc, timeout_s=5.0):
    """One request/reply op (degrade/inject/drain/health) against a live
    replica's line-JSON socket. Returns the reply doc."""
    with _socket.create_connection((host, int(port)), timeout=timeout_s) as s:
        s.settimeout(timeout_s)
        send_line(s, doc)
        reply = read_line(s.makefile("rb"))
    if reply is None:
        raise OSError(f"replica {host}:{port} closed without replying")
    return reply


class SpawnedReplica:
    """Handle on one replica subprocess the spawner owns."""

    def __init__(self, name, host, port, proc, generation="0", role="mixed"):
        self.name = str(name)
        self.host = str(host)
        self.port = int(port)
        self.proc = proc
        # weight-version tag the replica was booted on (which committed
        # checkpoint generation it serves)
        self.generation = str(generation if generation is not None else "0")
        # disaggregation role the worker was booted with
        self.role = str(role or "mixed")

    @property
    def pid(self):
        return self.proc.pid

    def alive(self):
        return self.proc.poll() is None

    def endpoint(self):
        return ReplicaEndpoint(self.name, self.host, self.port,
                               generation=self.generation, role=self.role)

    def __repr__(self):
        return (f"SpawnedReplica({self.name}, {self.host}:{self.port}, "
                f"gen={self.generation}, role={self.role}, "
                f"pid={self.pid}, alive={self.alive()})")


class ProcessReplicaSpawner:
    """Spawns/drains/kills ``replica.py`` worker processes.

    The autoscaler's muscle (and the chaos harness's): ``spawn()`` forks
    ``python -m deepspeed_tpu_torch.inference.serving.replica`` on an
    ephemeral port and blocks until the worker prints its
    ``{"ready": true, "port": N}`` line; ``drain()`` is the polite
    SIGTERM path (finish in-flight, exit ``EXIT_PREEMPTED``); ``kill()``
    is SIGKILL (the chaos harness's hard death)."""

    def __init__(self, config_path, host="127.0.0.1", env=None,
                 ready_timeout_s=120.0, config_for_generation=None):
        self.config_path = str(config_path)
        self.host = str(host)
        self.env = dict(env) if env is not None else None
        self.ready_timeout_s = float(ready_timeout_s)
        # optional resolver: weight tag -> replica config path, so a
        # spawn can boot a specific committed checkpoint generation (the
        # rollout controller's canary path). None = every spawn uses the
        # default config regardless of tag.
        self.config_for_generation = config_for_generation
        self._spawned = []
        self._lock = threading.Lock()
        self._seq = 0

    def spawn(self, name=None, generation=None, role=None):
        """Start one replica and wait for its ready line. ``generation``
        boots the replica on that weight tag (via the resolver) and
        stamps the handle so the router can pin retries to it; ``role``
        boots it as a disaggregated prefill/decode worker."""
        with self._lock:
            self._seq += 1
            name = name or (f"{role}-{self._seq}" if role
                            else f"replica-{self._seq}")
        config_path = self.config_path
        if generation is not None and self.config_for_generation is not None:
            config_path = str(self.config_for_generation(str(generation)))
        env = dict(self.env if self.env is not None else os.environ)
        # the package may be a repo checkout rather than installed: the
        # child must import deepspeed_tpu_torch regardless of the parent's cwd
        pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))))
        env["PYTHONPATH"] = pkg_root + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
        argv = [sys.executable, "-m",
                "deepspeed_tpu_torch.inference.serving.replica",
                "--config", config_path, "--port", "0",
                "--host", self.host]
        if role is not None:
            argv += ["--role", str(role)]
        proc = subprocess.Popen(
            argv, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, text=True)
        deadline = time.monotonic() + self.ready_timeout_s
        line = ""
        while time.monotonic() < deadline:
            line = proc.stdout.readline()
            if line:
                break
            if proc.poll() is not None:
                raise RuntimeError(
                    f"replica {name} died before ready (exit "
                    f"{proc.returncode})")
        try:
            ready = json.loads(line)
        except (ValueError, TypeError):
            proc.kill()
            raise RuntimeError(f"replica {name} bad ready line: {line!r}")
        if not ready.get("ready"):
            proc.kill()
            raise RuntimeError(f"replica {name} not ready: {ready}")
        handle = SpawnedReplica(name, self.host, int(ready["port"]), proc,
                                generation=generation,
                                role=ready.get("role") or role or "mixed")
        with self._lock:
            self._spawned.append(handle)
        return handle

    def drain(self, handle, wait_s=0.0):
        """SIGTERM the replica (drain + EXIT_PREEMPTED). Optionally wait
        up to ``wait_s`` for it to finish; returns True once exited."""
        if handle.alive():
            handle.proc.terminate()
        if wait_s > 0:
            try:
                handle.proc.wait(timeout=wait_s)
            except subprocess.TimeoutExpired:
                return False
        return not handle.alive()

    def kill(self, handle):
        """SIGKILL: the hard-death path (no drain, no flush)."""
        if handle.alive():
            handle.proc.kill()
        try:
            handle.proc.wait(timeout=10.0)
        except subprocess.TimeoutExpired:
            pass

    def stop_all(self, grace_s=5.0):
        """Terminate everything this spawner started (test teardown)."""
        with self._lock:
            spawned = list(self._spawned)
        for h in spawned:
            if h.alive():
                h.proc.terminate()
        deadline = time.monotonic() + grace_s
        for h in spawned:
            try:
                h.proc.wait(timeout=max(0.05, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                h.proc.kill()
                h.proc.wait()


class Autoscaler:
    """The SLO-driven control loop over one Router + one spawner.

    ``alerts`` is the pressure signal, any of: an ``/alerts`` URL
    (polled with the stdlib fetcher), an object with ``alerts_doc()``
    (an in-process :class:`SloEngine`), or a callable returning a bool
    or an alerts doc. ``replicas`` seeds the set of ALREADY-ROUTED
    handles (name-matched to the router's endpoints) so scale-down can
    drain the process it detaches."""

    def __init__(self, router, spawner, config=None, alerts=None,
                 replicas=(), ladder=None, registry=None,
                 clock=time.monotonic):
        self.router = router
        self.spawner = spawner
        self.config = config or AutoscaleConfig(enabled=True)
        self._alerts = alerts
        self._clock = clock
        self._lock = threading.Lock()
        self._active = {h.name: h for h in replicas}    # routed handles
        self._spares = []                               # warm, NOT routed
        # weight-version tag the pool targets: refills spawn on it, and
        # scale-up refuses to attach a spare from a different generation
        # (attaching stale weights mid-rollout would split the fleet).
        # None = untagged fleet, any spare attaches.
        self._weight_tag = None
        # fleet-level degrade ladder, driven only at the capacity ceiling
        self.ladder = ladder or DegradeLadder(
            None, on_change=self._push_rung, name="fleet")
        if ladder is not None:
            ladder._on_change = self._push_rung
        self._firing_since = None
        self._quiet_since = None
        self._last_action = -float("inf")
        self._last_alert = False
        self.scale_ups = 0
        self.scale_downs = 0
        self._thread = None
        self._stop = threading.Event()
        if registry is not None:
            self.export_gauges(registry)

    # -- the pressure signal --------------------------------------------
    def _alert_firing(self):
        """True while the SLO signal fires; None when unreadable (an
        unreachable alerts endpoint must hold state, not scale)."""
        src = self._alerts
        if src is None:
            return False
        try:
            if isinstance(src, str):
                url = src if src.endswith("/alerts") else src.rstrip("/") + "/alerts"
                doc = _http_json(url, 2.0)
            elif hasattr(src, "alerts_doc"):
                doc = src.alerts_doc()[1]
            else:
                doc = src()
        except Exception:
            return None
        if isinstance(doc, bool):
            return doc
        if isinstance(doc, dict):
            return bool(doc.get("firing", 0)) or doc.get("status") == "alerting"
        return bool(doc)

    # -- one control tick ------------------------------------------------
    def step(self, now=None):
        """One deterministic control tick; returns the action taken
        ("up" | "down" | "degrade" | None)."""
        now = self._clock() if now is None else now
        firing = self._alert_firing()
        if firing is None:
            return None                 # signal unreadable: hold state
        self._last_alert = firing
        if firing:
            self._quiet_since = None
            if self._firing_since is None:
                self._firing_since = now
        else:
            self._firing_since = None
            if self._quiet_since is None:
                self._quiet_since = now

        self._reap(now)
        action = None
        n = len(self.router.endpoints())
        cooled = now - self._last_action >= self.config.cooldown_s
        if (firing and cooled
                and now - self._firing_since >= self.config.up_after_s):
            if n < self.config.max_replicas:
                action = self._scale_up(now)
            else:
                action = "degrade"      # no headroom: climb the ladder
        if (not firing and cooled and self._quiet_since is not None
                and now - self._quiet_since >= self.config.down_after_s
                and n > self.config.min_replicas):
            action = self._scale_down(now)
        # the ladder sees pressure only when capacity can't answer it;
        # its own hysteresis handles rung-by-rung escalate/recover
        self.ladder.update(firing and n >= self.config.max_replicas,
                           now=now)
        self._refill_spares()
        return action

    # -- weight-version-aware spare pool ---------------------------------
    def set_weight_tag(self, tag):
        """Target weight generation for the spare pool (the rollout
        controller calls this on promote/rollback). Spares on a stale
        generation are drained — they can never be attached again."""
        tag = None if tag is None else str(tag)
        with self._lock:
            self._weight_tag = tag
            keep, stale = [], []
            for h in self._spares:
                (keep if self._spare_matches(h, tag) else stale).append(h)
            self._spares = keep
        for h in stale:
            self.spawner.drain(h)
        return tag

    @property
    def weight_tag(self):
        return self._weight_tag

    @staticmethod
    def _spare_matches(handle, tag):
        return tag is None or getattr(handle, "generation", "0") == tag

    def take_spares(self, tag, n):
        """Hand up to ``n`` live spares on weight tag ``tag`` to a
        caller (the rollout controller's canary boot), spawning the
        shortfall cold on that tag. The caller owns routing and drain of
        the returned handles. Spawn failures return a short list rather
        than raising — the caller decides whether a partial canary is
        acceptable."""
        tag = str(tag)
        out = []
        with self._lock:
            keep = []
            for h in self._spares:
                if (len(out) < n and h.alive()
                        and getattr(h, "generation", "0") == tag):
                    out.append(h)
                else:
                    keep.append(h)
            self._spares = keep
        while len(out) < n:
            try:
                out.append(self.spawner.spawn(generation=tag))
            except Exception:
                break
        return out

    def _scale_up(self, now):
        handle = None
        with self._lock:
            tag = self._weight_tag
            keep = []
            while self._spares:
                cand = self._spares.pop(0)
                if handle is None and cand.alive() \
                        and self._spare_matches(cand, tag):
                    handle = cand
                else:
                    keep.append(cand)
            self._spares = keep + self._spares
        if handle is None:
            try:                        # cold-start fallback, on the tag
                handle = (self.spawner.spawn() if tag is None
                          else self.spawner.spawn(generation=tag))
            except Exception:
                return None
        self.router.add_endpoint(handle.endpoint())
        with self._lock:
            self._active[handle.name] = handle
        self.scale_ups += 1
        self._last_action = now
        self._firing_since = now        # re-arm: one rung per threshold
        self._note("fleet/scale_up", replica=handle.name,
                   replicas=len(self.router.endpoints()))
        return "up"

    def _scale_down(self, now):
        eps = self.router.endpoints()
        # drain the newest attach first (LIFO keeps the stable core warm)
        with self._lock:
            name = next((h.name for h in reversed(list(self._active.values()))
                         if len(eps) > 1 and any(e.name == h.name
                                                 for e in eps)), None)
            handle = self._active.pop(name, None) if name else None
        if handle is None:
            return None
        try:
            self.router.remove_endpoint(handle.name)
        except ValueError:
            with self._lock:
                self._active[handle.name] = handle
            return None
        self.spawner.drain(handle)
        self.scale_downs += 1
        self._last_action = now
        self._quiet_since = now         # re-arm: one replica per threshold
        self._note("fleet/scale_down", replica=handle.name,
                   replicas=len(self.router.endpoints()))
        return "down"

    def _push_rung(self, old, new, reason):
        """Ladder transitions fan out to the whole fleet: the router
        sheds at rung 3; each replica applies rungs 1-2 engine-side."""
        self.router.set_degrade_rung(new)
        with self._lock:
            targets = list(self._active.values())
        for h in targets:
            if not h.alive():
                continue
            try:
                replica_op(h.host, h.port,
                           {"op": "degrade", "rung": new, "reason": reason})
            except OSError:
                pass                    # probe/breaker paths own dead ones

    def _reap(self, now):
        """Drop dead warm spares; dead ACTIVE replicas stay routed — the
        router's health probes already route around them, and the
        supervisor/breaker owns their restart story."""
        with self._lock:
            self._spares = [h for h in self._spares if h.alive()]

    def _refill_spares(self):
        """Top the warm-spare pool back up, one spawn per tick (spawns
        block on the ready line; one per tick keeps ticks bounded)."""
        with self._lock:
            want = (len(self._spares) < self.config.warm_spares
                    and len(self._active) + len(self._spares)
                    < self.config.max_replicas + self.config.warm_spares)
        if not want:
            return
        tag = self._weight_tag
        try:
            handle = (self.spawner.spawn() if tag is None
                      else self.spawner.spawn(generation=tag))
        except Exception:
            return
        with self._lock:
            self._spares.append(handle)

    # -- background loop -------------------------------------------------
    def start(self):
        """Run ``step()`` every ``poll_interval_s`` on a daemon thread."""
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="autoscaler", daemon=True)
        self._thread.start()
        return self

    def _loop(self):
        while not self._stop.is_set():
            try:
                self.step()
            except Exception:
                pass                    # the control loop must not die
            self._stop.wait(self.config.poll_interval_s)

    def stop(self, drain_spares=True):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(5.0)
            self._thread = None
        if drain_spares:
            with self._lock:
                spares, self._spares = self._spares, []
            for h in spares:
                self.spawner.drain(h)

    # -- observability ---------------------------------------------------
    def stats(self):
        with self._lock:
            spares = sum(1 for h in self._spares if h.alive())
        return {
            "replicas": float(len(self.router.endpoints())),
            "warm_spares": float(spares),
            "scale_ups": float(self.scale_ups),
            "scale_downs": float(self.scale_downs),
            "alert_firing": float(bool(self._last_alert)),
            "degrade_rung": float(self.ladder.rung),
        }

    def export_gauges(self, registry):
        registry.gauge_fn("Fleet/autoscaler", self.stats,
                          help="autoscaler control-loop state")
        self.ladder.export_gauges(registry)
        return registry

    def _note(self, name, **args):
        if "deepspeed_tpu_torch.telemetry" not in sys.modules:
            return
        try:
            from deepspeed_tpu_torch import telemetry
            telemetry.instant(name, cat="fleet", args=args)
        except Exception:
            pass


class _RoleBoundSpawner:
    """Spawner facade that pins every spawn to one disaggregation role
    (drain/kill/stop_all pass through untouched) — lets the unmodified
    :class:`Autoscaler` control loop grow a single role pool."""

    def __init__(self, spawner, role):
        self._spawner = spawner
        self.role = str(role)

    def spawn(self, name=None, generation=None):
        return self._spawner.spawn(name=name, generation=generation,
                                   role=self.role)

    def __getattr__(self, attr):
        return getattr(self._spawner, attr)


class _NoopLadder:
    """Inert DegradeLadder stand-in (rung pinned to 0)."""

    rung = 0

    def update(self, firing, now=None):
        return 0

    def export_gauges(self, registry):
        return registry


class _RolePoolView:
    """Router facade scoped to one role: ``endpoints()`` counts only
    that pool, so the wrapped Autoscaler's min/max bounds apply per role
    instead of fleet-wide. Mutations hit the real router."""

    def __init__(self, router, role):
        self._router = router
        self.role = str(role)

    def endpoints(self):
        return [e for e in self._router.endpoints()
                if getattr(e, "role", "mixed") == self.role]

    def __getattr__(self, attr):
        return getattr(self._router, attr)


class RolePoolAutoscaler:
    """Two role-scoped SLO control loops over ONE router.

    Disaggregated pools have disaggregated bottlenecks: queued prompts
    inflate TTFT on the prefill side while decode throughput is fine,
    and vice versa. So this controller runs TWO independent
    :class:`Autoscaler` loops against the same router — ``ttft_alerts``
    (TTFT p95 over budget) grows the prefill pool, ``decode_alerts``
    (decode tokens/s under floor) grows the decode pool — each bounded
    by its half of the ``fleet.roles`` config. Degrade-ladder escalation
    stays with the decode loop (the rung fans out fleet-wide anyway;
    two ladders would fight over the shared rung)."""

    def __init__(self, router, spawner, roles_config=None,
                 autoscale_config=None, ttft_alerts=None, decode_alerts=None,
                 prefill_replicas=(), decode_replicas=(), registry=None,
                 clock=time.monotonic):
        self.roles = roles_config or RolesConfig(enabled=True)
        base = autoscale_config or AutoscaleConfig(enabled=True)
        self.prefill = Autoscaler(
            _RolePoolView(router, "prefill"),
            _RoleBoundSpawner(spawner, "prefill"),
            config=_dc_replace(
                base, enabled=True,
                min_replicas=int(self.roles.prefill_replicas),
                max_replicas=int(self.roles.max_prefill_replicas)),
            alerts=ttft_alerts, replicas=prefill_replicas,
            clock=clock)
        # only ONE loop may own the fleet-wide degrade rung (two ladders
        # on one shared rung would fight): decode keeps the real ladder,
        # prefill gets an inert one
        self.prefill.ladder = _NoopLadder()
        self.decode = Autoscaler(
            _RolePoolView(router, "decode"),
            _RoleBoundSpawner(spawner, "decode"),
            config=_dc_replace(
                base, enabled=True,
                min_replicas=int(self.roles.decode_replicas),
                max_replicas=int(self.roles.max_decode_replicas)),
            alerts=decode_alerts, replicas=decode_replicas,
            clock=clock)
        if registry is not None:
            self.export_gauges(registry)

    def step(self, now=None):
        """One tick of both loops; returns {"prefill": act, "decode": act}."""
        return {"prefill": self.prefill.step(now),
                "decode": self.decode.step(now)}

    def start(self):
        self.prefill.start()
        self.decode.start()
        return self

    def stop(self, drain_spares=True):
        self.prefill.stop(drain_spares=drain_spares)
        self.decode.stop(drain_spares=drain_spares)

    def stats(self):
        out = {f"prefill_{k}": v for k, v in self.prefill.stats().items()}
        out.update({f"decode_{k}": v
                    for k, v in self.decode.stats().items()})
        return out

    def export_gauges(self, registry):
        registry.gauge_fn("Fleet/role_autoscaler", self.stats,
                          help="per-role (prefill/decode) autoscaler state")
        return registry
