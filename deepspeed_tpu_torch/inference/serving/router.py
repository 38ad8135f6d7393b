"""Fleet routing front-door: health-aware load balancing over N replicas.

A copy of ``deepspeed_tpu/inference/serving/router.py`` with only the
imports rebound: the wire protocol (``PROTOCOL_VERSION``), the config
keys, the error types and the counters are the JAX package's.

One :class:`ServingEngine` process answers one queue; this tier answers a
*fleet*. The :class:`Router` load-balances requests across replica
processes (each a ``replica.py`` worker under ``launcher/supervisor.py``)
speaking a line-delimited JSON protocol over local TCP sockets, and makes
the fleet survive exactly the faults the injectors can produce:

- **health-aware routing**: replicas are scored from their ``/healthz``
  + ``/snapshot`` telemetry endpoints (loop liveness, queue depth,
  draining flag — the ``DSTPU_TELEMETRY_PORT`` contract), with a
  socket-level ``{"op": "health"}`` probe as the no-telemetry fallback.
  Prefix-affinity hashing sends prompts sharing their first N tokens to
  the same replica so ``Serving/PrefixHitRate`` survives scale-out;
  least-loaded wins whenever the affinity target is unhealthy, draining,
  or saturated.
- **failover with exactly-once completion**: every request carries an
  idempotency key and a ``delivered`` high-water mark. On replica death
  (supervisor restart, ``EXIT_POISONED``, socket EOF, per-attempt
  timeout) the request is re-routed with ``from=delivered``: the new
  replica recomputes the full greedy generation (deterministic — same
  seed, same params) and replays only the missing suffix, so a
  ``stream_cb`` never sees a token twice and the final output is
  bitwise-identical to single-engine ``generate()``. Failure retries
  burn a bounded budget with exponential backoff + jitter; exhausting it
  quarantines the request with :class:`RequestPoisonedError` instead of
  crash-looping the fleet. Rejections (queue-full / draining / injected)
  re-route immediately WITHOUT burning budget — the request did nothing
  wrong.
- **drain awareness**: a replica answering ``rejected: draining`` (or
  advertising ``draining`` via health) leaves the rotation at once; its
  in-flight requests finish where they are (see replica.py's SIGTERM
  sequence).
- **overload shedding**: an admission controller sheds with a structured
  :class:`FleetOverloadError` (retry-after hint) when a request class'
  token budget is exhausted or every routable replica is saturated —
  failing fast at the door beats timing out deep in a queue.

Stdlib-only on purpose (sockets + threads + json): the module itself
imports no torch, and it is reusable from the launcher. Wire protocol
(one JSON object per line)::

    -> {"op": "submit", "key": K, "prompt": [...], "from": 0, ...}
    <- {"t": 17, "i": 0}            # token 0
    <- {"t": 4,  "i": 1}            # token 1
    <- {"done": true, "n": 2}       # terminal: success
    <- {"rejected": "queue_full" | "draining" | "injected"}
    <- {"error": msg, "etype": "RequestTimeoutError", "detail": {...}}
"""

import json
import random
import socket
import sys
import threading
import time
import uuid
import zlib
from urllib.error import HTTPError
from urllib.request import urlopen

from deepspeed_tpu_torch.inference.serving.config import FleetConfig
from deepspeed_tpu_torch.inference.serving.scheduler import (
    RequestTimeoutError,
    ServingFuture,
)

PROTOCOL_VERSION = 1

# replica roles for disaggregated prefill/decode serving. "mixed" runs
# both phases interleaved (the classic topology and the wire default: a
# health snapshot with no role field is treated as mixed so pre-role
# replicas keep routing unchanged). "prefill" workers run prompt
# processing and hand finished KV pages to a "decode" worker; "decode"
# workers only accept handoff installs + resumes, never fresh submits.
REPLICA_ROLES = ("prefill", "decode", "mixed")

# terminal error types a replica may report; anything else degrades to
# RuntimeError with the replica's message
_TERMINAL_ERRORS = {
    "RequestTimeoutError": None,     # reconstructed from detail below
    "ValueError": ValueError,
}


class FleetOverloadError(RuntimeError):
    """The router shed this request at admission: either its class'
    token budget is exhausted or every routable replica is saturated.
    ``retry_after_s`` is the client's backoff hint."""

    def __init__(self, reason, retry_after_s, request_class="default"):
        self.reason = reason            # "class_budget" | "saturated"
        self.retry_after_s = float(retry_after_s)
        self.request_class = request_class
        super().__init__(
            f"fleet overloaded ({reason}, class={request_class!r}); "
            f"retry after {retry_after_s:.2f}s")


class WrongRoleError(RuntimeError):
    """The fleet cannot serve this request kind at all: every attached
    endpoint is the wrong role (e.g. a plain submit against a fleet of
    pure decode workers). Structured — carries the request kind and the
    per-endpoint role map — so callers can tell a topology bug from a
    transient outage."""

    def __init__(self, request_kind, roles):
        self.request_kind = str(request_kind)
        self.roles = dict(roles)
        super().__init__(
            f"no endpoint can serve a {request_kind!r} request: "
            f"fleet roles are {self.roles}")


class RequestPoisonedError(RuntimeError):
    """A request failed on every retry and was quarantined: the retry
    budget is spent and the router will not crash-loop the fleet on it."""

    def __init__(self, key, attempts, last_error):
        self.key = key
        self.attempts = int(attempts)
        self.last_error = str(last_error)
        super().__init__(
            f"request {key} quarantined after {attempts} failed attempt(s); "
            f"last error: {last_error}")


def send_line(sock, doc):
    """One protocol frame: compact JSON + newline."""
    sock.sendall((json.dumps(doc, separators=(",", ":")) + "\n")
                 .encode("utf-8"))


def read_line(stream):
    """One frame off a socket file object; None at EOF."""
    line = stream.readline()
    if not line:
        return None
    return json.loads(line)


def _http_json(url, timeout_s):
    """GET a JSON doc; a 503 /healthz body still parses (unhealthy is an
    answer, not an outage)."""
    try:
        with urlopen(url, timeout=timeout_s) as resp:
            return json.loads(resp.read().decode("utf-8"))
    except HTTPError as e:
        return json.loads(e.read().decode("utf-8"))


class ReplicaEndpoint:
    """One replica's addresses + the router's live view of it."""

    def __init__(self, name, host, port, health_url=None, generation="0",
                 role="mixed"):
        self.name = str(name)
        self.host = str(host)
        self.port = int(port)
        # disaggregation role ("prefill" | "decode" | "mixed"); refreshed
        # from health probes — a snapshot without a role field means a
        # pre-role replica and maps to "mixed"
        role = str(role or "mixed")
        if role not in REPLICA_ROLES:
            raise ValueError(
                f"unknown replica role {role!r} "
                f"(known: {', '.join(REPLICA_ROLES)})")
        self.role = role
        # a role learned from a replica's `wrong_role` rejection: a later
        # health doc without a role field leaves it in place
        self.role_learned = False
        # telemetry endpoint ("http://127.0.0.1:9100"); None = probe the
        # serving socket with {"op": "health"} instead
        self.health_url = health_url.rstrip("/") if health_url else None
        # weight-version tag: which committed checkpoint generation this
        # replica serves. Greedy decoding is deterministic PER generation,
        # so exactly-once replay across replicas is only bitwise-safe
        # within one generation — retry selection pins on it.
        self.generation = str(generation if generation is not None else "0")
        # router-side view, refreshed by probes
        self.healthy = True
        self.draining = False
        self.removed = False        # detached via remove_endpoint()
        self.load_hint = 0          # queue_depth + active from last probe
        self.inflight = 0           # attempts the router has on this replica
        self.last_probe = 0.0
        # last SUCCESSFUL probe: a cached health snapshot older than
        # 2 x health_ttl_s is treated as unhealthy rather than routed on
        # (stale scores). Seeded to construction time: a fresh endpoint
        # gets one staleness window of benefit of the doubt.
        self.last_ok = time.monotonic()
        self.failures = 0           # consecutive probe/attempt failures

    @property
    def address(self):
        return (self.host, self.port)

    def __repr__(self):
        return (f"ReplicaEndpoint({self.name}, {self.host}:{self.port}, "
                f"gen={self.generation}, role={self.role}, "
                f"healthy={self.healthy}, draining={self.draining}, "
                f"load={self.load_hint}+{self.inflight})")


class _RoutedRequest:
    __slots__ = ("key", "prompt", "max_new_tokens", "eos_token_id",
                 "timeout_s", "stream_cb", "request_class", "cost",
                 "future", "delivered", "t0", "generation")

    def __init__(self, key, prompt, max_new_tokens, eos_token_id, timeout_s,
                 stream_cb, request_class, cost):
        self.key = key
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.eos_token_id = eos_token_id
        self.timeout_s = timeout_s
        self.stream_cb = stream_cb
        self.request_class = request_class
        self.cost = cost
        self.future = ServingFuture(key)
        self.delivered = 0          # exactly-once high-water mark
        self.t0 = time.monotonic()  # original submit time (age_s on retry)
        # weight generation that streamed the first token: once any token
        # is delivered, retries must stay on this generation (different
        # weights would replay a different suffix and break bitwise
        # exactly-once). None until then.
        self.generation = None


class Router:
    """Health-aware, failover-capable request router over a replica fleet."""

    def __init__(self, endpoints, config=None, registry=None,
                 probe_timeout_s=2.0, rng=None):
        self.config = config or FleetConfig(enabled=True)
        self.probe_timeout_s = float(probe_timeout_s)
        self._rng = rng or random.Random()
        self._endpoints = []
        for ep in endpoints:
            if not isinstance(ep, ReplicaEndpoint):
                ep = ReplicaEndpoint(*ep)
            self._endpoints.append(ep)
        if not self._endpoints:
            raise ValueError("router needs at least one replica endpoint")
        # stable order: the affinity hash must map a prefix to the same
        # replica in every router process
        self._endpoints.sort(key=lambda e: e.name)
        self._lock = threading.Lock()
        self._inflight_tokens = {}      # class -> tokens in flight
        self._inflight_requests = 0
        self._degrade_rung = 0          # rung 3 sheds classes at the door
        self._canary = None             # (generation, fraction) or None
        self._tap = None                # completion tap (shadow sampling)
        self._threads = set()
        self._closed = False
        self._counters = {
            "routed": 0,        # attempts dispatched to a replica
            "retried": 0,       # failure retries (budget-burning)
            "shed": 0,          # FleetOverloadError raised at admission
            "drained": 0,       # draining rejections observed
            "rejected": 0,      # queue_full / injected rejections observed
            "completed": 0,     # requests finished successfully
            "failed": 0,        # requests finished with a terminal error
            "poisoned": 0,      # requests quarantined
            "canary_routed": 0,  # attempts landed on the canary generation
            "handoff_routed": 0,     # two-hop prefill->decode routes tried
            "handoff_completed": 0,  # requests finished via the decode hop
            "handoff_failed": 0,     # page transfers that never acked
            "handoff_degraded": 0,   # edge-triggered falls to mixed mode
        }
        # edge state for the handoff-degraded instant: set when a decode
        # pool exists but cannot be routed to (requests fall back to the
        # interleaved plain path), cleared when a handoff routes again
        self._handoff_degraded_flag = False
        if registry is not None:
            self.export_gauges(registry)

    # -- metrics ---------------------------------------------------------
    def counters(self):
        with self._lock:
            out = dict(self._counters)
            out["inflight_requests"] = self._inflight_requests
            out["inflight_tokens"] = float(
                sum(self._inflight_tokens.values()))
        accepted = out["completed"] + out["failed"] + out["poisoned"] \
            + out["inflight_requests"]
        out["shed_rate"] = (out["shed"] / (out["shed"] + accepted)
                            if out["shed"] + accepted > 0 else 0.0)
        out["healthy_replicas"] = float(
            sum(1 for ep in self._endpoints
                if ep.healthy and not ep.draining))
        out["replicas"] = float(len(self._endpoints))
        out["degrade_rung"] = float(self._degrade_rung)
        return out

    def export_gauges(self, registry):
        """Pull gauges under ``Fleet/router/*`` (routed, retried, shed,
        drained, shed_rate, ...) so the SLO engine and the fleet
        collector can alert on them. Idempotent."""
        registry.gauge_fn(
            "Fleet/router",
            lambda: {k: float(v) for k, v in self.counters().items()},
            help="fleet router counters (routed/retried/shed/drained)")
        return registry

    # -- health ----------------------------------------------------------
    def _probe(self, ep, now=None, force=False):
        now = time.monotonic() if now is None else now
        if not force and now - ep.last_probe < self.config.health_ttl_s:
            return
        ep.last_probe = now
        try:
            if ep.health_url is not None:
                doc = _http_json(ep.health_url + "/healthz",
                                 self.probe_timeout_s)
                loop = doc.get("serving_loop") or {}
                rep = doc.get("replica") or {}
                ep.draining = bool(loop.get("draining")
                                   or rep.get("draining"))
                ep.healthy = doc.get("status") == "ok"
                ep.load_hint = (int(loop.get("queue_depth", 0))
                                + int(loop.get("active_requests", 0)))
                self._note_probed_role(ep, rep.get("role"))
            else:
                doc = self._socket_health(ep)
                ep.draining = bool(doc.get("draining"))
                ep.healthy = bool(doc.get("healthy", True))
                ep.load_hint = (int(doc.get("queue_depth", 0))
                                + int(doc.get("active_requests", 0)))
                self._note_probed_role(ep, doc.get("role"))
            ep.failures = 0
            # stamp the view when the probe finished: a probe slower than
            # the stale window must not leave a view that is born stale
            ep.last_ok = time.monotonic()
        except (OSError, ValueError):
            ep.healthy = False
            ep.failures += 1

    @staticmethod
    def _note_probed_role(ep, role):
        """A health doc's role is authoritative. A doc without one is a
        pre-role replica, mixed for wire compatibility, unless a
        `wrong_role` rejection already taught the router its real role."""
        if role:
            ep.role = str(role)
            ep.role_learned = False
        elif not ep.role_learned:
            ep.role = "mixed"

    def _socket_health(self, ep):
        with socket.create_connection(ep.address,
                                      timeout=self.probe_timeout_s) as sock:
            sock.settimeout(self.probe_timeout_s)
            send_line(sock, {"op": "health"})
            doc = read_line(sock.makefile("rb"))
        if doc is None:
            raise OSError("health probe: EOF")
        return doc

    def probe_all(self, force=True, now=None):
        """Refresh every endpoint's health view; returns the endpoints."""
        now = time.monotonic() if now is None else now
        eps = self._endpoints
        for ep in eps:
            self._probe(ep, now=now, force=force)
        return list(eps)

    # -- fleet membership (the autoscaler's contract) --------------------
    def endpoints(self):
        """Current endpoint list (a snapshot)."""
        return list(self._endpoints)

    def add_endpoint(self, ep, generation=None):
        """Attach a replica to the rotation (the autoscaler's scale-up:
        the process is already warm and listening, attach is O(1)).
        The list is re-sorted by name so the affinity hash stays stable
        across router processes. ``generation`` overrides the endpoint's
        weight-version tag (the rollout controller tags canaries here)."""
        if not isinstance(ep, ReplicaEndpoint):
            ep = ReplicaEndpoint(*ep)
        if generation is not None:
            ep.generation = str(generation)
        with self._lock:
            if any(e.name == ep.name for e in self._endpoints):
                raise ValueError(f"endpoint {ep.name!r} already routed")
            eps = self._endpoints + [ep]
            eps.sort(key=lambda e: e.name)
            self._endpoints = eps           # atomic swap: readers snapshot
        return ep

    def remove_endpoint(self, name):
        """Detach a replica from the rotation (the autoscaler's
        scale-down: the caller then SIGTERMs the process, which drains
        and exits ``EXIT_PREEMPTED``). In-flight attempts on it finish
        where they are; the endpoint is marked draining so nothing new
        lands during the handoff. Refuses to empty the fleet."""
        with self._lock:
            ep = next((e for e in self._endpoints if e.name == name), None)
            if ep is None:
                raise ValueError(f"no endpoint named {name!r}")
            if len(self._endpoints) == 1:
                raise ValueError("cannot remove the last endpoint")
            # flags first, THEN the list swap: a picker holding the old
            # list snapshot still sees removed/draining on the shared
            # endpoint object and skips it (the drain race fix — the swap
            # alone leaves a window where a mid-retry request re-selects
            # the detached replica from its stale snapshot)
            ep.removed = True
            ep.draining = True
            self._endpoints = [e for e in self._endpoints if e is not ep]
        return ep

    # -- canary slice (the rollout controller's contract) ----------------
    def set_canary(self, generation, fraction):
        """Route a deterministic ``fraction`` of NEW requests onto
        replicas tagged ``generation``. The slice is chosen by hashing
        the same prompt prefix the affinity hash uses, so a given prefix
        always lands in the same group and cache locality survives the
        split; within each group, prefix-affinity hashing applies
        unchanged. In-flight requests are never migrated."""
        fraction = float(fraction)
        if not 0.0 <= fraction <= 1.0:
            raise ValueError(f"canary fraction {fraction} not in [0, 1]")
        self._canary = (str(generation), fraction)
        return self._canary

    def clear_canary(self):
        """Drop the canary split: routing reverts to one undivided pool
        (rollback, or promotion once every replica is on the new tag)."""
        self._canary = None

    @property
    def canary(self):
        """(generation, fraction) of the active canary slice, or None."""
        return self._canary

    def _in_canary_slice(self, prompt, fraction):
        if fraction >= 1.0:
            return True
        if fraction <= 0.0:
            return False
        n = max(1, self.config.affinity_prefix_tokens)
        prefix = ",".join(str(int(t)) for t in prompt[:n]).encode("ascii")
        # salted so the slice decision decorrelates from the in-group
        # replica choice, but still a pure function of the prefix
        return (zlib.crc32(b"canary:" + prefix) % 10000) < fraction * 10000

    # -- completion tap (shadow traffic sampling) ------------------------
    def set_completion_tap(self, tap):
        """Install ``tap(info)`` called once per successfully completed
        request with ``{key, prompt, max_new_tokens, eos_token_id,
        request_class, tokens, generation, latency_s}``. The rollout
        controller samples these to replay as shadow traffic against the
        canary. Pass None to uninstall. Tap exceptions are swallowed —
        observation must not affect routing."""
        self._tap = tap

    # -- degraded-mode ladder (rung 3 lives here) ------------------------
    def set_degrade_rung(self, rung):
        """Fleet degrade rung as pushed by the autoscaler (or a test).
        The router acts on rung >= 3: per-class shedding at admission.
        Edge-triggered bookkeeping only — instants are the ladder
        owner's job."""
        self._degrade_rung = max(0, int(rung))
        return self._degrade_rung

    @property
    def degrade_rung(self):
        return self._degrade_rung

    def _routable(self, ep, now=None):
        if ep.removed:
            return False
        ttl = self.config.health_ttl_s
        if ttl > 0:
            now = time.monotonic() if now is None else now
            if now - ep.last_ok > 2.0 * ttl:
                # the health view went stale (probes failing or never
                # completing): don't route on old scores
                return False
        return ep.healthy and not ep.draining

    def _load(self, ep):
        return ep.load_hint + ep.inflight

    def _saturated(self, ep):
        return self._load(ep) >= max(1, self.config.saturation_queue_depth)

    # -- routing policy --------------------------------------------------
    def _affinity_target(self, prompt, eps=None):
        n = self.config.affinity_prefix_tokens
        eps = self._endpoints if eps is None else eps
        if n <= 0 or not eps:
            return None
        prefix = ",".join(str(int(t)) for t in prompt[:n]).encode("ascii")
        return eps[zlib.crc32(prefix) % len(eps)]

    def _pick(self, rr, avoid=None, eps=None, role="submit"):
        """Affinity target when healthy and unsaturated; else the
        least-loaded routable replica; None when nothing is routable.

        Role rules (disaggregated fleets): ``role="submit"`` — a plain
        interleaved request — never lands on a pure decode worker (those
        only accept handoff installs; routing one a fresh prompt is the
        wrong-role bug the replica would reject anyway).
        ``role="prefill"`` prefers strict prefill workers and falls back
        to mixed ones; ``role="decode"`` selects pure decode workers
        only. Mixed fleets (every role "mixed", the pre-disaggregation
        default) behave exactly as before.

        Generation rules: a request that has delivered tokens is pinned
        to the generation that produced them — a cross-generation replay
        would recompute a different suffix and break bitwise exactly-once
        — so candidates of other generations are never selected, even
        when that means returning None and backing off. An unpinned
        request under an active canary is assigned to the canary or
        incumbent slice by prefix hash; affinity then applies within the
        slice. ``eps`` exists for tests: pass a stale snapshot to prove
        removed endpoints are still skipped."""
        now = time.monotonic()
        eps = self._endpoints if eps is None else eps
        for ep in eps:
            self._probe(ep, now=now)
        candidates = [ep for ep in eps if self._routable(ep, now=now)]
        if role == "decode":
            candidates = [ep for ep in candidates if ep.role == "decode"]
        elif role == "prefill":
            strict = [ep for ep in candidates if ep.role == "prefill"]
            candidates = strict or [ep for ep in candidates
                                    if ep.role != "decode"]
        else:   # plain submit: anything that can run a full request
            candidates = [ep for ep in candidates if ep.role != "decode"]
        if avoid is not None and len(candidates) > 1:
            candidates = [ep for ep in candidates if ep is not avoid]
        if not candidates:
            return None
        pool = eps                   # affinity pool: stable across health
        if rr.generation is not None:
            same_gen = [ep for ep in candidates
                        if ep.generation == rr.generation]
            if not same_gen:
                return None
            candidates = same_gen
            pool = [ep for ep in eps if ep.generation == rr.generation]
        else:
            canary = self._canary
            if canary is not None:
                gen, frac = canary
                want = self._in_canary_slice(rr.prompt, frac)
                group = [ep for ep in candidates
                         if (ep.generation == gen) == want]
                if group:
                    candidates = group
                    pool = [ep for ep in eps
                            if (ep.generation == gen) == want]
                # an empty slice (canary crashed / not yet attached)
                # falls through to the full candidate set: traffic keeps
                # flowing on whatever is routable
        chosen = None
        target = self._affinity_target(rr.prompt, pool)
        if (target is not None and target in candidates
                and not self._saturated(target)):
            chosen = target
        else:
            chosen = min(candidates, key=self._load)
        # final re-validation: remove_endpoint() may have detached the
        # chosen replica after the candidate filter ran (flags are set on
        # the shared object before the list swap, so this check closes
        # the stale-snapshot window)
        if chosen.removed or chosen.draining:
            return None
        return chosen

    # -- admission control ----------------------------------------------
    def _class_budget(self, request_class):
        b = self.config.max_inflight_tokens
        if isinstance(b, dict):
            b = b.get(request_class, b.get("default", 0))
        return int(b or 0)

    def _shed_class(self, request_class):
        """Rung-3 (class_shed) verdict for one request class: the
        configured ``fleet.degrade.shed_classes``, or — with an empty
        list — every class EXCEPT the protected ``"default"``."""
        if self._degrade_rung < 3:
            return False
        classes = tuple(getattr(self.config.degrade, "shed_classes", ())
                        if getattr(self.config, "degrade", None) is not None
                        else ())
        if classes:
            return request_class in classes
        return request_class != "default"

    def _admit(self, rr):
        """Shed checks; reserves the class token budget on success."""
        if self._shed_class(rr.request_class):
            with self._lock:
                self._counters["shed"] += 1
            raise FleetOverloadError(
                "degraded", self.config.shed_retry_after_s,
                request_class=rr.request_class)
        budget = self._class_budget(rr.request_class)
        with self._lock:
            used = self._inflight_tokens.get(rr.request_class, 0)
            if budget > 0 and used + rr.cost > budget:
                self._counters["shed"] += 1
                raise FleetOverloadError(
                    "class_budget", self.config.shed_retry_after_s,
                    request_class=rr.request_class)
        # judge saturation on the view this call just took: staleness is
        # measured from the probe's start, so a slow probe or a thread
        # descheduled after it cannot turn a shed into an admission
        now = time.monotonic()
        routable = [ep for ep in self.probe_all(force=False, now=now)
                    if self._routable(ep, now)]
        if routable and all(self._saturated(ep) for ep in routable):
            with self._lock:
                self._counters["shed"] += 1
            raise FleetOverloadError(
                "saturated", self.config.shed_retry_after_s,
                request_class=rr.request_class)
        with self._lock:
            self._inflight_tokens[rr.request_class] = \
                self._inflight_tokens.get(rr.request_class, 0) + rr.cost
            self._inflight_requests += 1

    def _release(self, rr):
        with self._lock:
            left = self._inflight_tokens.get(rr.request_class, 0) - rr.cost
            self._inflight_tokens[rr.request_class] = max(0, left)
            self._inflight_requests -= 1

    # -- public API ------------------------------------------------------
    def submit(self, prompt, max_new_tokens=None, eos_token_id=None,
               timeout_s=None, stream_cb=None, request_class="default",
               key=None, shed_retries=0):
        """Route one request; returns a :class:`ServingFuture`.

        Raises :class:`FleetOverloadError` synchronously when shedding.
        ``shed_retries`` re-admits a shed request up to that many times,
        honoring the error's ``retry_after_s`` hint between attempts, so
        callers get load-aware backoff instead of a hot retry loop.
        Every other outcome — success, terminal error from the replica,
        :class:`RequestPoisonedError` after budget exhaustion — is
        delivered through the future."""
        if self._closed:
            raise RuntimeError("router is closed")
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("prompt must contain at least one token")
        cost = len(prompt) + int(max_new_tokens or 0)
        rr = _RoutedRequest(
            key or uuid.uuid4().hex, prompt,
            None if max_new_tokens is None else int(max_new_tokens),
            None if eos_token_id is None else int(eos_token_id),
            timeout_s, stream_cb, request_class, cost)
        attempts_left = max(0, int(shed_retries))
        while True:
            try:
                self._admit(rr)
                break
            except FleetOverloadError as exc:
                if attempts_left <= 0 or self._closed:
                    raise
                attempts_left -= 1
                time.sleep(max(0.0, float(exc.retry_after_s)))
        t = threading.Thread(target=self._run_request, args=(rr,),
                             name=f"router-{rr.key[:8]}", daemon=True)
        with self._lock:
            self._threads.add(t)
        t.start()
        return rr.future

    def close(self, timeout_s=5.0):
        self._closed = True
        with self._lock:
            threads = list(self._threads)
        deadline = time.monotonic() + timeout_s
        for t in threads:
            t.join(max(0.0, deadline - time.monotonic()))

    # -- the per-request worker ------------------------------------------
    def _run_request(self, rr):
        try:
            self._drive(rr)
        finally:
            self._release(rr)
            with self._lock:
                self._threads.discard(threading.current_thread())

    def _drive(self, rr):
        cfg = self.config
        failures = 0
        reroutes = 0
        avoid = None
        while True:
            ep = None
            decode_ep = None
            if self._handoff_wanted(rr):
                decode_ep = self._pick(rr, avoid=avoid, role="decode")
                if decode_ep is not None:
                    pre = self._pick(rr, avoid=avoid, role="prefill")
                    # generation guard: both hops replay within ONE weight
                    # generation or the spliced output is not bitwise
                    if (pre is not None and pre is not decode_ep
                            and pre.generation == decode_ep.generation):
                        ep = pre
                if ep is None:
                    # decode pool configured but unroutable right now:
                    # fall back to interleaved mixed mode (edge-triggered
                    # instant; requests keep flowing, just slower TTFT)
                    decode_ep = None
                    self._handoff_degraded(True)
            if ep is None:
                ep = self._pick(rr, avoid=avoid)
            if ep is None:
                eps = [e for e in self._endpoints if not e.removed]
                if eps and all(e.role == "decode" for e in eps):
                    # topology bug, not a transient outage: nothing in
                    # the fleet can EVER take a fresh prompt
                    with self._lock:
                        self._counters["failed"] += 1
                    rr.future._finish(WrongRoleError(
                        "submit", {e.name: e.role for e in eps}))
                    return
                failures += 1
                if failures > cfg.retry_budget:
                    self._finish_poisoned(rr, failures,
                                          "no routable replica")
                    return
                with self._lock:
                    self._counters["retried"] += 1
                avoid = None
                self._backoff(failures)
                continue
            blame = ep
            if decode_ep is not None:
                self._handoff_degraded(False)
                outcome, detail, blame = self._attempt_handoff(
                    rr, ep, decode_ep)
                if outcome == "handoff_failed":
                    # the transfer never landed (or the installed claim
                    # was lost): the prefill hop already streamed token 0,
                    # so re-route plain from the delivered high-water mark.
                    # Like a rejection this burns no retry budget — the
                    # request did nothing wrong — but rides the same
                    # bounded carousel.
                    with self._lock:
                        self._counters["handoff_failed"] += 1
                    blame.healthy = False
                    blame.failures += 1
                    avoid = None
                    reroutes += 1
                    if reroutes > max(4, 2 * len(self._endpoints)):
                        reroutes = 0
                        failures += 1
                        if failures > cfg.retry_budget:
                            self._finish_poisoned(
                                rr, failures,
                                f"handoff failed everywhere ({detail})")
                            return
                        with self._lock:
                            self._counters["retried"] += 1
                        self._backoff(failures)
                    continue
            else:
                outcome, detail = self._attempt(rr, ep)
            if outcome == "done":
                with self._lock:
                    self._counters["completed"] += 1
                rr.future._finish()
                tap = self._tap
                if tap is not None:
                    try:
                        tap({"key": rr.key, "prompt": list(rr.prompt),
                             "max_new_tokens": rr.max_new_tokens,
                             "eos_token_id": rr.eos_token_id,
                             "request_class": rr.request_class,
                             "tokens": rr.future.tokens,
                             "generation": ep.generation,
                             "latency_s": max(
                                 0.0, time.monotonic() - rr.t0)})
                    except Exception:
                        pass    # observation must not affect routing
                return
            if outcome == "terminal":
                with self._lock:
                    self._counters["failed"] += 1
                rr.future._finish(self._terminal_exception(detail))
                return
            if outcome == "rejected":
                # the replica said no before doing work: re-route without
                # burning retry budget, but bound the carousel
                with self._lock:
                    self._counters[
                        "drained" if detail == "draining"
                        else "rejected"] += 1
                if detail == "draining":
                    blame.draining = True
                avoid = blame
                reroutes += 1
                if reroutes > max(4, 2 * len(self._endpoints)):
                    reroutes = 0
                    failures += 1
                    if failures > cfg.retry_budget:
                        self._finish_poisoned(
                            rr, failures, f"rejected everywhere ({detail})")
                        return
                    with self._lock:
                        self._counters["retried"] += 1
                    self._backoff(failures)
                continue
            # outcome == "failed": the replica died / wedged mid-attempt
            # (``blame`` is the hop that actually failed — the decode
            # worker on a post-ack death, not the innocent prefill)
            blame.healthy = False
            blame.failures += 1
            failures += 1
            if failures > cfg.retry_budget:
                self._finish_poisoned(rr, failures, detail)
                return
            with self._lock:
                self._counters["retried"] += 1
            avoid = blame
            self._backoff(failures)

    # -- disaggregated prefill/decode routing ----------------------------
    def _handoff_wanted(self, rr):
        """Plan a two-hop prefill->decode route? Only for FRESH requests
        (``delivered == 0`` — a retry with delivered tokens replays plain
        from its high-water mark), only when decoding will actually
        happen (``max_new_tokens > 1``; a 1-token request IS its prefill),
        and only when the fleet has a decode pool at all."""
        return (rr.delivered == 0
                and rr.max_new_tokens is not None
                and int(rr.max_new_tokens) > 1
                and any(e.role == "decode" and not e.removed
                        for e in self._endpoints))

    def _attempt_handoff(self, rr, pre_ep, decode_ep):
        """One two-hop attempt: prefill on ``pre_ep`` (which streams the
        first token, then ships the KV pages to ``decode_ep``), then
        resume on ``decode_ep``. Returns (outcome, detail, blame) where
        ``blame`` is the endpoint at fault for a non-done outcome.

        The handoff key is fresh per attempt — the replica-side
        idempotency (dup-ack on re-send, installed-claim takeover) keys
        on it, and reusing a key across logically different attempts
        would alias unrelated transfers."""
        hkey = f"{rr.key}:{uuid.uuid4().hex[:8]}"
        with self._lock:
            self._counters["handoff_routed"] += 1
        outcome, detail = self._attempt(rr, pre_ep, extra={
            "handoff": {"host": decode_ep.host, "port": decode_ep.port,
                        "key": hkey}})
        if outcome != "handoff_done":
            if outcome == "handoff_failed":
                why = (detail or {}).get("error", "page transfer failed")
                # the prefill worker exhausted its bounded retries against
                # the decode worker: the decode side is the suspect
                return "handoff_failed", why, decode_ep
            return outcome, detail, pre_ep
        # hop 2: resume on the decode worker from the installed pages
        outcome, detail = self._attempt(rr, decode_ep, extra={
            "handoff_key": hkey})
        if outcome == "rejected" and detail == "handoff_unknown":
            # acked but gone (reaped, or the decode worker restarted
            # between ack and resume): fall back to a plain replay
            return "handoff_failed", "installed claim lost", decode_ep
        if outcome == "done":
            with self._lock:
                self._counters["handoff_completed"] += 1
        return outcome, detail, decode_ep

    def _handoff_degraded(self, degraded, reason="decode pool unroutable"):
        """Edge-triggered degraded-mode bookkeeping: the first fall from
        disaggregated to interleaved routing bumps the counter and emits
        a ``fleet/handoff_degraded`` instant; recovery re-arms the edge
        (and emits the matching restore instant)."""
        if degraded and not self._handoff_degraded_flag:
            self._handoff_degraded_flag = True
            with self._lock:
                self._counters["handoff_degraded"] += 1
            self._note("fleet/handoff_degraded", reason=reason)
        elif not degraded and self._handoff_degraded_flag:
            self._handoff_degraded_flag = False
            self._note("fleet/handoff_restored")

    def _note(self, name, **args):
        """Emit a telemetry instant IF the telemetry subsystem is already
        imported (the router is stdlib-only by design — it must never be
        the first importer of anything heavy)."""
        if "deepspeed_tpu_torch.telemetry" not in sys.modules:
            return
        try:
            from deepspeed_tpu_torch import telemetry
            telemetry.instant(name, cat="fleet", args=args)
        except Exception:
            pass    # observation must not affect routing

    def _backoff(self, n):
        base = self.config.retry_backoff_s * (2 ** max(0, n - 1))
        delay = min(base, self.config.retry_backoff_max_s)
        time.sleep(delay * (0.5 + self._rng.random()))

    def _finish_poisoned(self, rr, attempts, last_error):
        with self._lock:
            self._counters["poisoned"] += 1
        rr.future._finish(
            RequestPoisonedError(rr.key, attempts, last_error))

    @staticmethod
    def _terminal_exception(doc):
        etype = doc.get("etype", "")
        detail = doc.get("detail") or {}
        if etype == "RequestTimeoutError":
            return RequestTimeoutError(
                detail.get("request_id", doc.get("key", "?")),
                detail.get("timeout_s"), detail.get("phase", "decoding"),
                tokens_done=detail.get("tokens_done", 0))
        exc_cls = _TERMINAL_ERRORS.get(etype) or RuntimeError
        return exc_cls(doc.get("error", "replica error"))

    def _attempt(self, rr, ep, extra=None):
        """One routed attempt. Returns (outcome, detail): "done",
        ("terminal", error-doc), ("rejected", reason), or
        ("failed", why) — only "failed" burns retry budget. With a
        handoff ``extra`` two more outcomes appear: ("handoff_done", doc)
        — the prefill hop streamed its token and the pages acked on the
        decode side, proceed to hop 2 — and ("handoff_failed", doc)."""
        timeout = self.config.attempt_timeout_s or None
        canary = self._canary
        with self._lock:
            self._counters["routed"] += 1
            if canary is not None and ep.generation == canary[0]:
                self._counters["canary_routed"] += 1
        ep.inflight += 1
        sock = None
        try:
            sock = socket.create_connection(ep.address, timeout=timeout)
            sock.settimeout(timeout)
            doc = {
                "op": "submit", "v": PROTOCOL_VERSION, "key": rr.key,
                "prompt": rr.prompt, "max_new_tokens": rr.max_new_tokens,
                "eos_token_id": rr.eos_token_id, "timeout_s": rr.timeout_s,
                "from": rr.delivered,
                "age_s": max(0.0, time.monotonic() - rr.t0)}
            if extra:
                doc.update(extra)
            send_line(sock, doc)
            stream = sock.makefile("rb")
            while True:
                doc = read_line(stream)
                if doc is None:
                    return "failed", "socket EOF (replica died?)"
                if "t" in doc:
                    i = int(doc.get("i", -1))
                    if i == rr.delivered:
                        self._deliver(rr, int(doc["t"]), ep)
                    elif i > rr.delivered:
                        return "failed", (
                            f"token gap: got index {i}, "
                            f"delivered {rr.delivered}")
                    # i < delivered: replayed duplicate — never re-emitted
                elif doc.get("done"):
                    n = int(doc.get("n", rr.delivered))
                    if n != rr.delivered:
                        return "failed", (
                            f"done at n={n} but delivered {rr.delivered}")
                    return "done", None
                elif doc.get("handoff_done"):
                    return "handoff_done", doc
                elif doc.get("handoff_failed"):
                    return "handoff_failed", doc
                elif "rejected" in doc:
                    if doc["rejected"] == "wrong_role" and doc.get("role"):
                        # the router's role view was stale — adopt the
                        # replica's own answer so the re-pick is informed
                        role = str(doc["role"])
                        if role in REPLICA_ROLES:
                            ep.role = role
                            ep.role_learned = True
                    return "rejected", str(doc["rejected"])
                elif "error" in doc:
                    return "terminal", doc
                else:
                    return "failed", f"unintelligible frame: {doc!r}"
        except (OSError, ValueError) as e:
            # connect refused, reset, per-attempt inactivity timeout,
            # or torn JSON from a dying replica — all the same verdict
            return "failed", f"{type(e).__name__}: {e}"
        finally:
            ep.inflight -= 1
            if sock is not None:
                try:
                    sock.close()
                except OSError:
                    pass

    def _deliver(self, rr, token, ep):
        if rr.generation is None:
            rr.generation = ep.generation   # pin: retries stay bitwise
        rr.future._append(token)
        rr.delivered += 1
        if rr.stream_cb is not None:
            try:
                rr.stream_cb(rr.key, token)
            except Exception:   # a broken callback must not kill routing
                pass
