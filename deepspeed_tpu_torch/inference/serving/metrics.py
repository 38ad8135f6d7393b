"""Serving metrics: TTFT, decode tokens per second, occupancy, the
prefill/decode split, speculation's accept rate and tokens a step, the
prefix cache's hit rate and reused tokens, the spill tier, the KV
handoff's lifecycle; and ``RolloutMetrics``, the weight rollout's.

Port of ``deepspeed_tpu/inference/serving/metrics.py``; the snapshot
keys are the JAX package's, so ``Serving/PrefixHitRate`` and the rest
read the same. All aggregation is on the host and O(1) per step; TTFT
percentiles sort a bounded window of samples only when read. Given a
monitor (``monitor_from_config``: tensorboard, csv, the telemetry
bridge), each hook also records the JAX package's ``Serving/*`` and
``Rollout/*`` scalars, which the monitor writes at ``close()`` (or its
own auto-flush).
"""

import time
from collections import deque

# TTFT percentile window: newest samples win once full
_TTFT_WINDOW = 8192


def _percentile(sorted_samples, q):
    """Nearest-rank percentile over an ascending list."""
    if not sorted_samples:
        return None
    n = len(sorted_samples)
    rank = max(1, -(-q * n // 100))              # ceil(q/100 * n)
    return sorted_samples[min(int(rank), n) - 1]


class ServingMetrics:
    """Aggregates serving counters and forwards gauges to a monitor."""

    def __init__(self, monitor=None):
        self.monitor = monitor
        self.decode_steps = 0
        self.tokens_emitted = 0
        self.requests_completed = 0
        self.requests_timed_out = 0
        self.decode_time_s = 0.0
        self.prefill_calls = 0
        self.prefill_tokens = 0
        self.prefill_reused_tokens = 0
        self.prefill_requests = 0
        self.prefill_time_s = 0.0
        self.prefill_chunks = 0
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.spill_hits = 0
        self.spill_misses = 0
        self.spill_corrupt_total = 0
        self._spill_stats_fn = None
        self._host_rss_mb_fn = None
        self.draft_proposed = 0
        self.draft_accepted = 0
        self.kv_pool_bytes = 0
        self.pages_in_use = 0
        self.page_fragmentation = 0.0
        self.batch_occupancy = 0.0
        self.queue_depth = 0
        # disaggregated prefill/decode handoff (record_handoff; an event
        # beyond these still counts, as an attribute of its own)
        self.handoff_exports = 0
        self.handoff_installs = 0
        self.handoff_dup_installs = 0
        self.handoff_resumes = 0
        self.handoff_reaped = 0
        self._admitted_by_bucket = {}
        self._ttft_sum = 0.0
        self._ttft_count = 0
        self._ttft_max = 0.0
        self._ttft_window = deque(maxlen=_TTFT_WINDOW)
        self._started = time.monotonic()

    # -- recording hooks (engine calls these) ---------------------------
    def record_first_token(self, ttft_s):
        self._ttft_sum += ttft_s
        self._ttft_count += 1
        self._ttft_max = max(self._ttft_max, ttft_s)
        self._ttft_window.append(ttft_s)
        self._record("Serving/ttft_s", ttft_s, self._ttft_count)

    def record_prefill(self, tokens, requests, prefill_s, reused_tokens=0):
        """One prefill call: ``tokens`` computed (the suffix only on a
        prefix hit), ``reused_tokens`` seeded from the prefix cache, over
        ``requests`` prompts in ``prefill_s`` seconds."""
        self.prefill_calls += 1
        self.prefill_tokens += tokens
        self.prefill_reused_tokens += reused_tokens
        self.prefill_time_s += prefill_s
        self.prefill_requests += requests
        if prefill_s > 0:
            self._record("Serving/prefill_tokens_per_sec", tokens / prefill_s,
                         self.prefill_calls)
        self._record("Serving/prefill_batch", requests, self.prefill_calls)

    def record_prefill_chunk(self):
        """One chunk of a chunked prefill ran."""
        self.prefill_chunks += 1

    def record_prefix_lookup(self, hit):
        if hit:
            self.prefix_hits += 1
        else:
            self.prefix_misses += 1
        lookups = self.prefix_hits + self.prefix_misses
        self._record("Serving/PrefixHitRate", self.prefix_hits / lookups, lookups)

    def record_spill_lookup(self, hit):
        """One spill-tier consult on the counted path: ``hit`` when the
        entry served was just promoted out of the spill tier."""
        if hit:
            self.spill_hits += 1
        else:
            self.spill_misses += 1
        lookups = self.spill_hits + self.spill_misses
        self._record("Serving/SpillHitRate", self.spill_hits / lookups, lookups)

    def record_spill_corrupt(self):
        """A spilled entry failed its checksum or framing on promotion and
        was dropped (the request fell through to a normal prefill)."""
        self.spill_corrupt_total += 1
        self._record("Serving/spill_corrupt_total", self.spill_corrupt_total,
                     self.spill_corrupt_total)

    def set_spill_sources(self, spill_stats_fn=None, host_rss_mb_fn=None):
        """Pull sources for the snapshot: ``spill_stats_fn`` -> the
        SpillStore's ``stats()`` dict, ``host_rss_mb_fn`` -> host RSS
        (MiB)."""
        self._spill_stats_fn = spill_stats_fn
        self._host_rss_mb_fn = host_rss_mb_fn

    def record_admission(self, bucket, prompt_len):
        """One admitted prompt: its true length under the bucket it was
        admitted to (the per-bucket prompt-length histogram)."""
        h = self._admitted_by_bucket.get(bucket)
        if h is None:
            self._admitted_by_bucket[bucket] = [1, prompt_len, prompt_len, prompt_len]
        else:
            h[0] += 1
            h[1] += prompt_len
            h[2] = min(h[2], prompt_len)
            h[3] = max(h[3], prompt_len)
        self._record(f"Serving/admitted_prompt_len_bucket_{bucket}", prompt_len,
                     self._admitted_by_bucket[bucket][0])

    def record_completion(self):
        self.requests_completed += 1

    def record_timeout(self):
        self.requests_timed_out += 1

    def record_step(self, queue_depth, active_slots, max_slots, tokens_this_step,
                    step_s, accepted_tokens=0, proposed_tokens=0, pages_in_use=0,
                    page_fragmentation=0.0):
        """One decode step. Under speculation ``proposed_tokens`` is k times
        the active lanes and ``accepted_tokens`` the drafts the oracle
        confirmed."""
        self.decode_steps += 1
        self.tokens_emitted += tokens_this_step
        self.decode_time_s += step_s
        self.pages_in_use = pages_in_use
        self.page_fragmentation = page_fragmentation
        self.batch_occupancy = active_slots / max_slots if max_slots else 0.0
        self.queue_depth = queue_depth
        step = self.decode_steps
        self._record("Serving/queue_depth", queue_depth, step)
        self._record("Serving/pages_in_use", pages_in_use, step)
        self._record("Serving/page_fragmentation", page_fragmentation, step)
        self._record("Serving/batch_occupancy", self.batch_occupancy, step)
        if step_s > 0:
            self._record("Serving/tokens_per_sec", tokens_this_step / step_s, step)
        self._record("Serving/tokens_per_step", tokens_this_step, step)
        if proposed_tokens > 0:
            self.draft_proposed += proposed_tokens
            self.draft_accepted += accepted_tokens
            self._record("Serving/accept_rate", accepted_tokens / proposed_tokens, step)

    def record_handoff(self, event):
        """One KV-handoff lifecycle event: 'export' (prefill side, pages
        copied at retire), 'install' / 'dup_install' (decode side, pages
        landed / an idempotent re-send dropped), 'resume' (a lane activated
        from installed pages), 'reaped' (an orphaned claim freed by the TTL
        reaper)."""
        attr = f"handoff_{event}" if event.endswith("ed") else f"handoff_{event}s"
        setattr(self, attr, getattr(self, attr, 0) + 1)
        self._record(f"Serving/{attr}", getattr(self, attr), 1)

    def record_kv_pool_bytes(self, nbytes):
        self.kv_pool_bytes = int(nbytes)
        self._record("Serving/kv_pool_bytes", int(nbytes), 1)

    def _record(self, tag, value, step):
        if self.monitor is not None:
            self.monitor.record(tag, value, step)

    # -- reading --------------------------------------------------------
    def avg_ttft_s(self):
        return self._ttft_sum / self._ttft_count if self._ttft_count else None

    def ttft_percentiles(self):
        """(p50, p95) over the recent TTFT window, (None, None) empty."""
        window = sorted(self._ttft_window)
        return _percentile(window, 50), _percentile(window, 95)

    def tokens_per_sec(self):
        """Decode-loop throughput (excludes idle time and prefill)."""
        if self.decode_time_s <= 0:
            return None
        return self.tokens_emitted / self.decode_time_s

    def prefill_tokens_per_sec(self):
        if self.prefill_time_s <= 0:
            return None
        return self.prefill_tokens / self.prefill_time_s

    def prefix_hit_rate(self):
        lookups = self.prefix_hits + self.prefix_misses
        return self.prefix_hits / lookups if lookups else None

    def spill_hit_rate(self):
        lookups = self.spill_hits + self.spill_misses
        return self.spill_hits / lookups if lookups else None

    def accept_rate(self):
        """Cumulative draft acceptance rate; None before any speculative
        step."""
        if self.draft_proposed <= 0:
            return None
        return self.draft_accepted / self.draft_proposed

    def tokens_per_step(self):
        """Mean emitted tokens per decode step."""
        if self.decode_steps <= 0:
            return None
        return self.tokens_emitted / self.decode_steps

    def snapshot(self):
        p50, p95 = self.ttft_percentiles()
        snap = {
            "decode_steps": self.decode_steps,
            "tokens_emitted": self.tokens_emitted,
            "requests_completed": self.requests_completed,
            "requests_timed_out": self.requests_timed_out,
            "tokens_per_sec": self.tokens_per_sec(),
            "decode_time_s": self.decode_time_s,
            "avg_ttft_s": self.avg_ttft_s(),
            "max_ttft_s": self._ttft_max if self._ttft_count else None,
            "ttft_p50_s": p50,
            "ttft_p95_s": p95,
            "prefill_tokens": self.prefill_tokens,
            "decode_tokens": self.tokens_emitted,
            "prefill_calls": self.prefill_calls,
            "prefill_requests": self.prefill_requests,
            "prefill_chunks": self.prefill_chunks,
            "prefill_tokens_per_sec": self.prefill_tokens_per_sec(),
            "prefix_reused_tokens": self.prefill_reused_tokens,
            "prefix_hit_rate": self.prefix_hit_rate(),
            "accept_rate": self.accept_rate(),
            "tokens_per_step": self.tokens_per_step(),
            "draft_proposed": self.draft_proposed,
            "draft_accepted": self.draft_accepted,
            "kv_pool_bytes": self.kv_pool_bytes,
            "pages_in_use": self.pages_in_use,
            "page_fragmentation": self.page_fragmentation,
            "batch_occupancy": self.batch_occupancy,
            "queue_depth": self.queue_depth,
            "handoff_exports": self.handoff_exports,
            "handoff_installs": self.handoff_installs,
            "handoff_dup_installs": self.handoff_dup_installs,
            "handoff_resumes": self.handoff_resumes,
            "handoff_reaped": self.handoff_reaped,
            "spill_hit_rate": self.spill_hit_rate(),
            "spill_corrupt_total": self.spill_corrupt_total,
            "uptime_s": time.monotonic() - self._started,
        }
        if self._spill_stats_fn is not None:
            try:
                sstats = self._spill_stats_fn() or {}
            except Exception:
                sstats = {}
            snap["spill_bytes"] = sstats.get("bytes", 0)
            snap["spill_disk_bytes"] = sstats.get("disk_bytes", 0)
            snap["spill_entries"] = sstats.get("entries", 0)
        if self._host_rss_mb_fn is not None:
            rss = self._host_rss_mb_fn()
            if rss is not None:
                snap["host_rss_mb"] = rss
        for bucket in sorted(self._admitted_by_bucket):
            count, total, lo, hi = self._admitted_by_bucket[bucket]
            snap[f"admitted_prompts_bucket_{bucket}"] = count
            snap[f"admitted_prompt_len_mean_bucket_{bucket}"] = total / count
            snap[f"admitted_prompt_len_min_bucket_{bucket}"] = lo
            snap[f"admitted_prompt_len_max_bucket_{bucket}"] = hi
        return snap

    def export_to(self, registry, name="Serving/Snapshot"):
        """Expose the numeric ``snapshot()`` fields as pull gauges on a
        telemetry registry."""
        registry.gauge_fn(
            name,
            lambda: {k: v for k, v in self.snapshot().items()
                     if isinstance(v, (int, float)) and not isinstance(v, bool)},
            help="live ServingMetrics.snapshot()")
        return registry

    def close(self):
        if self.monitor is not None:
            self.monitor.flush()


# rollout phases in escalation order; the phase gauge exports the index
ROLLOUT_PHASES = ("idle", "staging", "canary", "promoting", "rolling_back",
                  "committed")


class RolloutMetrics:
    """Counters and gauges of the weight-rollout state machine.

    Per-rollout counters (shadow compares, shadow diffs, canary crashes)
    reset when ``begin_rollout`` starts the next attempt, so a diff rate
    describes this canary; fleet-lifetime counters (rollouts, rollbacks,
    commits) only grow. Exported under ``Rollout/*``."""

    def __init__(self, monitor=None):
        self.monitor = monitor
        self.phase = "idle"
        self.target_tag = None
        # lifetime
        self.rollouts_total = 0
        self.rollbacks_total = 0
        self.commits_total = 0
        # per rollout (reset by begin_rollout)
        self.shadow_compared_total = 0
        self.shadow_diff_total = 0
        self.canary_crashes = 0
        self.last_rollback_reason = None
        self.last_recovery_s = None

    def begin_rollout(self, tag):
        self.rollouts_total += 1
        self.target_tag = str(tag)
        self.shadow_compared_total = 0
        self.shadow_diff_total = 0
        self.canary_crashes = 0
        self.last_rollback_reason = None
        self.last_recovery_s = None
        self.set_phase("staging")

    def set_phase(self, phase):
        if phase not in ROLLOUT_PHASES:
            raise ValueError(f"unknown rollout phase {phase!r}")
        self.phase = phase
        self._record("Rollout/phase", float(ROLLOUT_PHASES.index(phase)), self.rollouts_total)

    def record_shadow(self, matched):
        self.shadow_compared_total += 1
        if not matched:
            self.shadow_diff_total += 1
        self._record("Rollout/shadow_diff_total", float(self.shadow_diff_total),
                     self.shadow_compared_total)

    def record_canary_crash(self):
        self.canary_crashes += 1

    def record_rollback(self, reason):
        self.rollbacks_total += 1
        self.last_rollback_reason = str(reason)
        self._record("Rollout/rollbacks_total", float(self.rollbacks_total),
                     self.rollouts_total)

    def record_commit(self):
        self.commits_total += 1

    def _record(self, tag, value, step):
        if self.monitor is not None:
            self.monitor.record(tag, value, step)

    def shadow_diff_rate(self):
        if self.shadow_compared_total <= 0:
            return 0.0
        return self.shadow_diff_total / self.shadow_compared_total

    def snapshot(self):
        return {
            "phase": float(ROLLOUT_PHASES.index(self.phase)),
            "rollouts_total": float(self.rollouts_total),
            "rollbacks_total": float(self.rollbacks_total),
            "commits_total": float(self.commits_total),
            "shadow_compared_total": float(self.shadow_compared_total),
            "shadow_diff_total": float(self.shadow_diff_total),
            "shadow_diff_rate": float(self.shadow_diff_rate()),
            "canary_crashes": float(self.canary_crashes),
            "last_recovery_s": float(self.last_recovery_s or 0.0),
        }

    def export_to(self, registry, name="Rollout"):
        """Pull gauges under ``Rollout/*``, so the SLO engine and the fleet
        collector can alert on a stuck or flapping rollout."""
        registry.gauge_fn(name, self.snapshot,
                          help="weight-rollout state machine counters")
        return registry
