"""Worker supervision for the per-node launcher.

Port of ``deepspeed_tpu/launcher/supervisor.py``, for a group of local
workers: ``launch.py`` starts one process per GPU, and a rank that dies
leaves NCCL communicators the others cannot repair. So the supervisor
runs the node's workers as one group. When any of them dies, exits other
than cleanly or goes stale, it stops every other local worker (SIGTERM,
then the grace period, then SIGKILL) and restarts the whole group; each
worker has its own heartbeat file; signals are forwarded to every
worker; and the group's exit class is the worst of the classes of the
members that exited on their own (a member the supervisor stopped is
not counted). Workers are started with ``subprocess`` (never ``fork``:
CUDA may be initialized in the parent). With one worker it is the JAX
package's supervisor.

``launch.py`` used to spawn the training process exactly once and raise on
any nonzero exit — on preemptible machines that turns every SIGTERM into a
dead job. ``WorkerSupervisor`` wraps the children with:

- **liveness monitoring** via a heartbeat file the engine touches at every
  optimizer-step boundary (``DSTPU_HEARTBEAT_FILE``, one a worker): a
  stale heartbeat means the worker is wedged (not just slow — the engine
  beats even while recovering), so the supervisor kills and restarts the
  group;
- **bounded restart with exponential backoff**: crashes restart up to
  ``max_restarts`` times with ``backoff_s * 2^(n-1)`` sleeps (capped);
  a preempted-resumable exit restarts promptly, without backoff;
- **distinct exit classes** (the exit-code contract below): clean exits and
  poisoned-fatal exits never restart; preempted-resumable and crash/hang
  exits do, while the restart budget lasts;
- **signal forwarding**: SIGTERM *and* SIGINT are forwarded to every
  worker (so the engine's ``PreemptionHandler`` can commit an emergency
  checkpoint), escalating terminate → ``wait(grace)`` → kill. A signal
  received by the supervisor itself means the *job* is being torn down:
  the workers' worst exit code is propagated and no restart happens.

Exit-code contract (shared with ``runtime/resilience/preemption.py``):

=================  ====  =============================================
``EXIT_CLEAN``     0     training finished; do not restart
``EXIT_POISONED``  98    poisoned/fatal (e.g. unrecoverable divergence);
                         restarting would fail the same way — do not
``EXIT_PREEMPTED`` 99    preemption checkpoint committed; resumable —
                         restart without backoff
other nonzero / signal   crash; restart with exponential backoff
=================  ====  =============================================

This module is stdlib-only on purpose: the supervisor must stay importable
(and restart workers) even when the training stack itself is the thing
crashing. The optional telemetry endpoint (``http_port``) is imported
lazily from ``deepspeed_tpu_torch.telemetry`` — itself stdlib-only — and
only when requested, so the no-telemetry path never touches it.
"""

import os
import signal
import subprocess
import sys
import tempfile
import time

EXIT_CLEAN = 0
EXIT_POISONED = 98
EXIT_PREEMPTED = 99

# Env contract between the supervisor and the engine it supervises.
HEARTBEAT_FILE_ENV = "DSTPU_HEARTBEAT_FILE"
PREEMPTION_ENV = "DSTPU_PREEMPTION"
PREEMPT_SAVE_DIR_ENV = "DSTPU_PREEMPT_SAVE_DIR"
# Worker-side telemetry endpoint port (duplicated in telemetry/config.py —
# neither package may import the other eagerly): a worker whose telemetry
# block leaves http_port null binds this port instead, so the fleet
# collector knows where to scrape it.
TELEMETRY_PORT_ENV = "DSTPU_TELEMETRY_PORT"
# Serving-replica socket port and config path (duplicated in
# inference/serving/replica.py): a supervised serving replica binds a
# fixed port, so the router's endpoint list survives restarts.
REPLICA_PORT_ENV = "DSTPU_REPLICA_PORT"
REPLICA_CONFIG_ENV = "DSTPU_REPLICA_CONFIG"

# Exit classes (WorkerSupervisor.exit_history entries).
CLASS_CLEAN = "clean"
CLASS_PREEMPTED = "preempted"
CLASS_FATAL = "fatal"
CLASS_CRASH = "crash"
CLASS_HUNG = "hung"
# a group's class is its worst member's, in this order (fatal worst)
_SEVERITY = (CLASS_CLEAN, CLASS_PREEMPTED, CLASS_CRASH, CLASS_HUNG, CLASS_FATAL)


def classify_exit(returncode, fatal_exit_codes=(EXIT_POISONED,)):
    """Map a child exit code to its supervision class. Signal deaths come
    through as negative returncodes and classify as crashes."""
    if returncode == EXIT_CLEAN:
        return CLASS_CLEAN
    if returncode == EXIT_PREEMPTED:
        return CLASS_PREEMPTED
    if returncode in fatal_exit_codes:
        return CLASS_FATAL
    return CLASS_CRASH


class CrashLoopBreaker:
    """Per-worker crash-loop circuit breaker (the ``fleet.breaker`` block).

    Exponential backoff alone caps restart RATE but still burns the
    restart budget on a worker that dies the same way every time — and a
    serving replica mid-crash-loop keeps a live-looking endpoint the
    router wastes retries on. The breaker adds the missing state:

    - ``closed``: failures accumulate; ``threshold`` failure exits
      (crash/hung — never clean or preempted) inside ``window_s`` OPEN
      the breaker.
    - ``open``: the worker stays down for ``cooldown_s`` (its dead port
      makes the router's health probe fail, so the fleet routes around
      the quarantined endpoint without any extra coordination).
    - ``half_open``: after the cooldown exactly ONE probe restart is
      allowed. The probe failing re-opens with a fresh cooldown; the
      probe exiting clean/preempted closes the breaker.

    Deliberately clock-injectable and supervisor-agnostic so the chaos
    harness and unit tests can drive it through years of simulated
    crash-loops in milliseconds."""

    def __init__(self, threshold=3, window_s=30.0, cooldown_s=5.0,
                 clock=time.monotonic):
        self.threshold = max(1, int(threshold))
        self.window_s = float(window_s)
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self.state = "closed"
        self.open_count = 0             # times the breaker has opened
        self._failures = []             # failure timestamps inside window
        self._opened_at = 0.0

    @classmethod
    def from_config(cls, cfg, clock=time.monotonic):
        """Build from a ``BreakerConfig``-shaped object or dict; None when
        the block is absent or disabled."""
        if cfg is None or isinstance(cfg, CrashLoopBreaker):
            return cfg
        if isinstance(cfg, dict):
            if not cfg.get("enabled", True):
                return None
            return cls(threshold=cfg.get("threshold", 3),
                       window_s=cfg.get("window_s", 30.0),
                       cooldown_s=cfg.get("cooldown_s", 5.0), clock=clock)
        if not getattr(cfg, "enabled", True):
            return None
        return cls(threshold=getattr(cfg, "threshold", 3),
                   window_s=getattr(cfg, "window_s", 30.0),
                   cooldown_s=getattr(cfg, "cooldown_s", 5.0), clock=clock)

    @property
    def is_open(self):
        return self.state == "open"

    def record_failure(self, now=None):
        """Note one failure exit; returns True when this failure OPENS
        the breaker (the edge the telemetry instant fires on)."""
        now = self._clock() if now is None else now
        if self.state == "half_open":
            # the single probe failed: straight back to quarantine with a
            # fresh cooldown (and a fresh window — the probe IS evidence)
            self.state = "open"
            self._opened_at = now
            self._failures = [now]
            self.open_count += 1
            return True
        self._failures = [t for t in self._failures
                          if now - t <= self.window_s]
        self._failures.append(now)
        if self.state == "closed" and len(self._failures) >= self.threshold:
            self.state = "open"
            self._opened_at = now
            self.open_count += 1
            return True
        return False

    def record_success(self, now=None):
        """A clean/preempted exit closes the breaker and clears history."""
        self.state = "closed"
        self._failures = []

    def restart_delay_s(self, now=None):
        """Seconds the supervisor must hold the worker down: the
        remaining quarantine when open, else 0 (normal backoff rules)."""
        if self.state != "open":
            return 0.0
        now = self._clock() if now is None else now
        return max(0.0, self._opened_at + self.cooldown_s - now)

    def allow_probe(self, now=None):
        """True when a restart may proceed. An open breaker past its
        cooldown transitions to half_open (the one probe); an open
        breaker inside it refuses."""
        if self.state != "open":
            return True
        now = self._clock() if now is None else now
        if now >= self._opened_at + self.cooldown_s:
            self.state = "half_open"
            return True
        return False


class WorkerSupervisor:
    """Run a node's group of worker processes under restart supervision.

    ``cmd`` runs once a worker; ``local_envs`` holds one dict a worker,
    laid over ``env`` (``[{}]``, one worker, by default). ``run()`` blocks
    until the group exits in a non-restartable way (or the restart budget
    is exhausted) and returns the exit code the caller should propagate.
    """

    def __init__(self, cmd, env=None, max_restarts=0, backoff_s=1.0,
                 max_backoff_s=30.0, heartbeat_timeout_s=0.0,
                 heartbeat_file=None, poll_interval_s=0.05, term_grace_s=5.0,
                 fatal_exit_codes=(EXIT_POISONED,), log=None, http_port=None,
                 worker_port=None, breaker=None, rank=None, local_envs=None,
                 replica_port=None, replica_config=None):
        self.cmd = list(cmd)
        self.env = dict(env if env is not None else os.environ)
        self.local_envs = [dict(e) for e in (local_envs or [{}])]
        self.max_restarts = int(max_restarts)
        self.backoff_s = float(backoff_s)
        self.max_backoff_s = float(max_backoff_s)
        self.heartbeat_timeout_s = float(heartbeat_timeout_s)
        self.poll_interval_s = float(poll_interval_s)
        self.term_grace_s = float(term_grace_s)
        self.fatal_exit_codes = tuple(fatal_exit_codes)
        self._log = log or (lambda msg: print(f"[supervisor] {msg}", file=sys.stderr, flush=True))

        # one heartbeat file a worker: `heartbeat_file` itself for a single
        # worker, `heartbeat_file.<i>` for worker i of a group
        n = len(self.local_envs)
        if self.heartbeat_timeout_s > 0 and heartbeat_file is None:
            fd, heartbeat_file = tempfile.mkstemp(prefix="dstorch_heartbeat_")
            os.close(fd)
        self.heartbeat_file = heartbeat_file
        self.heartbeat_files = ([None] * n if heartbeat_file is None else
                                [heartbeat_file] if n == 1 else
                                [f"{heartbeat_file}.{i}" for i in range(n)])
        # children auto-install the engine PreemptionHandler under a supervisor
        self.env.setdefault(PREEMPTION_ENV, "1")
        # a fixed worker telemetry port makes the workers scrapable by the
        # fleet collector across restarts (an ephemeral port would move);
        # worker i binds worker_port + i
        self.worker_port = worker_port
        # a serving replica keeps a fixed request socket across restarts
        # too: worker i binds replica_port + i, and reads its spec from
        # replica_config
        self.replica_port = replica_port
        if replica_config is not None:
            self.env[REPLICA_CONFIG_ENV] = str(replica_config)

        # crash-loop circuit breaker (fleet.breaker): accepts a built
        # CrashLoopBreaker, a BreakerConfig-shaped object/dict, or None
        self.breaker = CrashLoopBreaker.from_config(breaker)
        self.rank = int(rank if rank is not None
                        else os.environ.get("RANK", "0") or 0)
        self.consecutive_failures = 0   # failure exits since last clean

        self.children = []
        self.restarts = 0
        self.exit_history = []  # [(exit_class, returncode), ...] of the group
        self.member_history = []  # [[(exit_class, returncode), ...] a worker, ...]
        self._shutdown_signal = None
        self._spawned_at = 0.0
        self.http_port = http_port
        self.telemetry_server = None

    @property
    def child(self):
        """The first worker (the only one of a single-worker group)."""
        return self.children[0] if self.children else None

    def worker_env(self, i):
        """The environment worker ``i`` is started with."""
        env = dict(self.env)
        env.update(self.local_envs[i])
        if self.heartbeat_files[i] is not None:
            env[HEARTBEAT_FILE_ENV] = self.heartbeat_files[i]
        if self.worker_port is not None:
            env[TELEMETRY_PORT_ENV] = str(int(self.worker_port) + i)
        if self.replica_port is not None:
            env[REPLICA_PORT_ENV] = str(int(self.replica_port) + i)
        return env

    # -- lifecycle -----------------------------------------------------
    def run(self):
        prev = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                prev[sig] = signal.signal(sig, self._on_signal)
            except ValueError:  # not the main thread (tests): no forwarding
                pass
        if self.http_port is not None:
            self._start_telemetry_server()
        try:
            return self._supervise()
        finally:
            self._stop_all()
            if self.telemetry_server is not None:
                self.telemetry_server.stop()
            for sig, handler in prev.items():
                signal.signal(sig, handler)

    def _supervise(self):
        while True:
            self._spawn()
            cls, returncode = self._wait()
            if self._shutdown_signal is not None:
                # the supervisor itself was told to stop: propagate the
                # workers' verdict (EXIT_PREEMPTED when they checkpointed)
                self._log(
                    f"shutting down on signal {self._shutdown_signal}; "
                    f"workers exited {returncode}"
                )
                return returncode
            self.exit_history.append((cls, returncode))
            if cls in (CLASS_CLEAN, CLASS_PREEMPTED):
                self.consecutive_failures = 0
                if self.breaker is not None:
                    self.breaker.record_success()
            else:
                self.consecutive_failures += 1
            self._note_exit(cls, returncode)
            if cls == CLASS_CLEAN:
                return EXIT_CLEAN
            if cls == CLASS_FATAL:
                self._log(f"worker exit {returncode} is fatal (poisoned); not restarting")
                return returncode
            if self.restarts >= self.max_restarts:
                self._log(
                    f"worker {cls} (exit {returncode}); restart budget "
                    f"exhausted ({self.restarts}/{self.max_restarts})"
                )
                return returncode if returncode != 0 else 1
            self.restarts += 1
            if cls == CLASS_PREEMPTED:
                delay = 0.0  # resumable checkpoint committed: come back fast
            else:
                delay = min(self.backoff_s * (2 ** (self.restarts - 1)), self.max_backoff_s)
            if self.breaker is not None and cls in (CLASS_CRASH, CLASS_HUNG):
                if self.breaker.record_failure():
                    self._note_breaker_open(cls, returncode)
                    self._log(
                        f"crash-loop breaker OPEN after "
                        f"{self.consecutive_failures} consecutive failures; "
                        f"quarantined {self.breaker.cooldown_s:.1f}s"
                    )
                # quarantine dominates backoff while the breaker is open
                delay = max(delay, self.breaker.restart_delay_s())
            self._note_restart(cls, returncode, delay)
            self._log(
                f"worker {cls} (exit {returncode}); restart "
                f"{self.restarts}/{self.max_restarts} in {delay:.1f}s"
            )
            if delay > 0:
                time.sleep(delay)
            if self.breaker is not None:
                # open -> half_open: the next spawn is the single probe
                self.breaker.allow_probe()

    def _spawn(self):
        # subprocess, never fork: CUDA may be initialized in this process
        self.children = [subprocess.Popen(self.cmd, env=self.worker_env(i))
                         for i in range(len(self.local_envs))]
        self._spawned_at = time.monotonic()

    def _wait(self):
        """Poll the workers until the group is done. Returns the group's
        (exit class, returncode): the worst class among the workers that
        exited on their own or went stale, with that worker's returncode.
        A worker that exits other than cleanly, or goes stale, ends the
        group: the others are stopped and not counted. Every worker's own
        (class, returncode) is appended to ``member_history``."""
        n = len(self.children)
        own = [None] * n          # (class, returncode) of a worker that ended by itself
        stopped = set()
        term_deadline = kill_deadline = None
        while True:
            now = time.monotonic()
            for i, child in enumerate(self.children):
                if own[i] is not None or i in stopped:
                    continue
                rc = child.poll()
                if rc is not None:
                    own[i] = (classify_exit(rc, self.fatal_exit_codes), rc)
                elif self._shutdown_signal is None and self._heartbeat_stale(i, now):
                    age = now - self._last_beat(i, now)
                    self._log(
                        f"worker {i}: heartbeat stale ({age:.1f}s > "
                        f"{self.heartbeat_timeout_s}s): wedged; killing it"
                    )
                    self._stop([child])
                    own[i] = (CLASS_HUNG, child.returncode)
            failed = [i for i in range(n) if own[i] is not None and own[i][0] != CLASS_CLEAN]
            live = [i for i in range(n) if own[i] is None and i not in stopped]
            if failed and live and self._shutdown_signal is None:
                # a dead rank's peers cannot finish (their NCCL groups are
                # broken): stop them, the group restarts as a whole (under
                # a forwarded signal every worker is winding down already)
                self._log(f"worker(s) {failed} ended {[own[i] for i in failed]}; "
                          f"stopping the other local worker(s) {live}")
                self._stop([self.children[i] for i in live])
                stopped.update(live)
                live = []
            if self._shutdown_signal is not None and live:
                if term_deadline is None:
                    term_deadline = now + self.term_grace_s
                elif now >= term_deadline and kill_deadline is None:
                    self._log("workers ignored the forwarded signal; terminating")
                    for i in live:
                        self.children[i].terminate()
                    kill_deadline = now + self.term_grace_s
                elif kill_deadline is not None and now >= kill_deadline:
                    self._log("workers ignored terminate; killing")
                    for i in live:
                        self.children[i].kill()
                        self.children[i].wait()
                        own[i] = (classify_exit(self.children[i].returncode,
                                                self.fatal_exit_codes),
                                  self.children[i].returncode)
                    live = []
            if not live:
                break
            time.sleep(self.poll_interval_s)
        self.member_history.append([own[i] if own[i] is not None else
                                    ("stopped", self.children[i].returncode)
                                    for i in range(n)])
        counted = [o for o in own if o is not None]
        return max(counted, key=lambda o: _SEVERITY.index(o[0]))

    def _heartbeat_stale(self, i, now):
        if self.heartbeat_timeout_s <= 0 or self.heartbeat_files[i] is None:
            return False
        return now - self._last_beat(i, now) > self.heartbeat_timeout_s

    def _last_beat(self, i, now):
        """Monotonic time of worker ``i``'s newest sign of life: spawn
        counts as one (a worker gets a full timeout to produce its first
        step)."""
        try:
            mtime = os.path.getmtime(self.heartbeat_files[i])
        except OSError:
            return self._spawned_at
        # mtime is wall-clock; convert its age into the monotonic domain
        return max(self._spawned_at, now - max(0.0, time.time() - mtime))

    def _stop(self, children):
        """terminate → wait(grace) → kill escalation, for all of
        ``children`` at once: every live one is sent SIGTERM first, then
        all share one grace deadline, then the ones still running are
        killed."""
        live = [c for c in children if c.poll() is None]
        for child in live:
            child.terminate()
        deadline = time.monotonic() + self.term_grace_s
        for child in live:
            try:
                child.wait(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                child.kill()
                child.wait()

    def _stop_all(self):
        """No worker outlives the supervisor."""
        self._stop(self.children)

    # -- telemetry (all lazily imported; no-ops unless requested) ------
    def _telemetry(self):
        """The telemetry package, or None. Imported only when the endpoint
        was requested or something else in-process already loaded it, so a
        bare supervisor never drags the package in just to note an exit."""
        if self.http_port is None and "deepspeed_tpu_torch.telemetry" not in sys.modules:
            return None
        try:
            from deepspeed_tpu_torch import telemetry
            return telemetry
        except Exception:
            return None

    def _start_telemetry_server(self):
        from deepspeed_tpu_torch import telemetry
        from deepspeed_tpu_torch.telemetry import TelemetryServer

        srv = TelemetryServer(registry=telemetry.get_registry(),
                              tracer=telemetry.get_tracer(),
                              port=int(self.http_port))
        srv.add_health_provider("worker", self._worker_health)
        srv.add_snapshot_provider("supervisor", self._snapshot)
        self.export_gauges(telemetry.get_registry())
        self.telemetry_server = srv.start()
        self._log(f"telemetry endpoint at {srv.url}")
        return srv

    @property
    def worker_endpoints(self):
        """The workers' telemetry URLs (for a fleet collector), worker i
        at ``worker_port + i``; None when no fixed ``worker_port`` was
        configured."""
        if self.worker_port is None:
            return None
        return [f"http://127.0.0.1:{int(self.worker_port) + i}"
                for i in range(len(self.local_envs))]

    @property
    def replica_endpoints(self):
        """``(host, port)`` of each supervised serving replica's request
        socket (a Router's endpoint list), worker i at ``replica_port +
        i``; None when the workers are not serving replicas."""
        if self.replica_port is None:
            return None
        return [("127.0.0.1", int(self.replica_port) + i)
                for i in range(len(self.local_envs))]

    def export_gauges(self, registry):
        """Register the supervisor's liveness as pull ``gauge_fn``s: a
        ``/fleet/metrics`` scrape sees restart counts, heartbeat age and
        child liveness without parsing trace events. Idempotent
        (re-registration overwrites), callable without a server too."""

        def _liveness():
            out = {"restarts": float(self.restarts),
                   "worker_alive": float(self._alive())}
            if self.heartbeat_file is not None and self._spawned_at > 0:
                out["heartbeat_age_s"] = self._oldest_beat_age()
            return out

        # kept for dashboard compatibility with the older name
        registry.gauge_fn("Supervisor/restarts", lambda: float(self.restarts),
                          help="worker restarts performed so far")
        registry.gauge_fn("Supervisor/worker", _liveness,
                          help="supervised worker liveness")
        # fleet-facing per-rank health: the collector's Fleet/* rollups
        # (and the autoscaler reading them) see crash-loop state without
        # parsing exit history; both reset on a clean/preempted exit
        registry.gauge_fn(
            f"Fleet/rank{self.rank}/restarts_consecutive",
            lambda: float(self.consecutive_failures),
            help="failure exits since this worker last exited clean")
        registry.gauge_fn(
            f"Fleet/rank{self.rank}/breaker_open",
            lambda: float(self.breaker is not None and self.breaker.is_open),
            help="1 while this worker's crash-loop breaker is open")
        return registry

    def _alive(self):
        """Every worker of the group is running."""
        return bool(self.children) and all(c.poll() is None for c in self.children)

    def _oldest_beat_age(self):
        now = time.monotonic()
        return max(max(0.0, now - self._last_beat(i, now))
                   for i in range(len(self.local_envs)))

    def _worker_health(self):
        alive = self._alive()
        doc = {"healthy": alive, "restarts": self.restarts,
               "max_restarts": self.max_restarts, "workers": len(self.local_envs)}
        if alive and self.heartbeat_file is not None:
            now = time.monotonic()
            doc["heartbeat_age_s"] = round(self._oldest_beat_age(), 3)
            if any(self._heartbeat_stale(i, now) for i in range(len(self.children))):
                doc["healthy"] = False
                doc["reason"] = "heartbeat stale"
        return doc

    def _snapshot(self):
        return {
            "restarts": self.restarts,
            "max_restarts": self.max_restarts,
            "exit_history": [
                {"class": cls, "returncode": rc} for cls, rc in self.exit_history
            ],
            "child_pids": [c.pid for c in self.children],
            "child_alive": self._alive(),
        }

    def _note_exit(self, cls, returncode):
        tel = self._telemetry()
        if tel is None:
            return
        tel.instant("worker/exit", cat="lifecycle",
                    args={"class": cls, "returncode": returncode,
                          "restarts": self.restarts})
        tel.get_registry().counter(
            f"Supervisor/exits/{cls}",
            help="worker exits by supervision class").inc()

    def _note_breaker_open(self, cls, returncode):
        tel = self._telemetry()
        if tel is None:
            return
        tel.instant("fleet/breaker_open", cat="fleet",
                    args={"rank": self.rank, "class": cls,
                          "returncode": returncode,
                          "consecutive_failures": self.consecutive_failures,
                          "cooldown_s": self.breaker.cooldown_s,
                          "open_count": self.breaker.open_count})
        tel.get_registry().counter(
            "Fleet/breaker_opens_total",
            help="crash-loop breaker open events").inc()

    def _note_restart(self, cls, returncode, delay):
        tel = self._telemetry()
        if tel is None:
            return
        tel.instant("worker/restart", cat="lifecycle",
                    args={"class": cls, "returncode": returncode,
                          "restart": self.restarts,
                          "max_restarts": self.max_restarts,
                          "delay_s": delay})
        tel.get_registry().counter(
            "Supervisor/restarts_total",
            help="worker restarts performed by the supervisor").inc()

    def _on_signal(self, signum, frame):
        self._shutdown_signal = signum
        for child in self.children:
            if child.poll() is None:
                try:
                    child.send_signal(signum)
                except OSError:
                    pass
