"""ZeRO model-state memory estimators: a pure-Python copy of
``deepspeed_tpu/runtime/zero/mem_estimator.py`` (the same accounting and
the same numbers for the same arguments), to answer "will this model fit
under this config?" before an engine is built.

Accounting (bytes per device unless noted), for P parameters trained with
Adam under mixed precision (bf16/fp16 compute, fp32 master):

- replicated compute params:   2P (bf16), all stages < 3; 2P / dp at
                               rest under stage 3
- compute-dtype gradients:     2P, transient out of backward
- flat fp32 gradients:         4P (stage < 2), 4P / dp (stage 2+)
- fp32 master:                 4P / dp (stages 1-3; absent for fp32 compute)
- Adam moments (m, v):         8P / dp
- under cpu_offload, in host RAM: the fp32 master 4P and the moments 8P,
  whole per process; the ping-pong partner 4P when streamed (K >= 2); the
  gradient staging, 4P sequentially or two buckets of ceil(4P / K)
  streamed.

The port keeps one difference from this accounting: under cpu_offload its
engine still accumulates the gradients in a flat fp32 buffer on the card
(4P), which the JAX engine's host step does without. Activations are not
included.
"""



def _fmt(n):
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(n) < 1024.0:
            return f"{n:.1f}{unit}"
        n /= 1024.0
    return f"{n:.1f}PB"


def estimate_zero_model_states_mem_needs(
        num_params, stage=2, dp=1, cpu_offload=False, compute_bytes=2,
        offload_stream_buckets=1):
    """Model-state memory for one training replica.

    Returns ``{"device_bytes", "host_bytes", "breakdown"}`` — per-device
    HBM and per-host RAM for params + gradients + optimizer states.
    ``compute_bytes=2`` is bf16/fp16 compute; use 4 for fp32 compute
    (then no separate master is stored — master_from_params).
    ``offload_stream_buckets`` selects the offload tier's host layout:
    K >= 2 bounds grad staging at two in-flight buckets of ceil(4P/K)
    bytes but adds the 4P ping-pong master partner the out-of-place
    streamed step commits into.
    """
    if stage not in (0, 1, 2, 3):
        raise ValueError(f"stage must be 0..3, got {stage}")
    if cpu_offload and stage not in (1, 2):
        raise ValueError("cpu_offload composes with ZeRO stage 1/2 only")
    if dp < 1:
        raise ValueError(f"dp must be >= 1, got {dp}")
    K = int(offload_stream_buckets)
    if K < 1:
        raise ValueError(f"offload_stream_buckets must be >= 1, got {K}")
    P = int(num_params)
    keep_master = compute_bytes != 4

    breakdown = {}
    device = host = 0

    if stage >= 3:
        param_bytes = compute_bytes * P // dp
        breakdown["params (sharded at rest)"] = param_bytes
    else:
        param_bytes = compute_bytes * P
        breakdown["params (replicated)"] = param_bytes
    device += param_bytes

    if cpu_offload:
        # The offload tier follows the implementation, not the generic
        # sharded layout: the host step fetches the compute-dtype grad
        # leaves directly (no flat fp32 grad buffer ever materializes on
        # device — this row used to over-report HBM), and the host master/
        # moments are FULL per-process vectors (always stored, even for
        # fp32 compute), plus the bucketed staging high-water mark.
        breakdown["gradients (compute, transient)"] = compute_bytes * P
        device += compute_bytes * P
        breakdown["fp32 master (host)"] = 4 * P
        # K >= 2: the streamed step writes out-of-place into a second full
        # master (ping-pong) so the H2D commit can adopt views copy-free
        pingpong = 4 * P if K >= 2 else 0
        breakdown["master ping-pong partner (host)"] = pingpong
        breakdown["Adam moments (host)"] = 8 * P
        staging = 4 * P if K == 1 else 2 * (-(-4 * P // K))
        breakdown["grad staging (host, high-water)"] = staging
        host += 4 * P + pingpong + 8 * P + staging
        return {"device_bytes": device, "host_bytes": host,
                "breakdown": breakdown}

    if compute_bytes != 4:
        # backward's compute-dtype grads exist transiently alongside the
        # flat fp32 copy (for fp32 compute the flat copy IS that buffer)
        breakdown["gradients (compute, transient)"] = compute_bytes * P
        device += compute_bytes * P
    grad_bytes = 4 * P // dp if stage >= 2 else 4 * P
    breakdown["gradients (fp32 flat)"] = grad_bytes
    device += grad_bytes

    master_bytes = 4 * P // dp if keep_master else 0
    moments_bytes = 8 * P // dp
    if stage == 0:
        master_bytes = 4 * P if keep_master else 0
        moments_bytes = 8 * P
    breakdown["fp32 master"] = master_bytes
    breakdown["Adam moments"] = moments_bytes
    device += master_bytes + moments_bytes

    return {"device_bytes": device, "host_bytes": host,
            "breakdown": breakdown}


def estimate_zero2_model_states_mem_needs(num_params, dp=1, cpu_offload=False,
                                          offload_stream_buckets=1):
    """The reference-family entry point name (later DeepSpeed API)."""
    return estimate_zero_model_states_mem_needs(
        num_params, stage=2, dp=dp, cpu_offload=cpu_offload,
        offload_stream_buckets=offload_stream_buckets)


def mem_needs_report(num_params, dp_sizes=(1, 8, 64), stages=(0, 1, 2, 3)):
    """Human-readable table over (stage, dp) — the later-DeepSpeed
    estimator's printed form."""
    lines = [f"model states for {num_params / 1e6:.0f}M params (Adam, "
             "bf16 compute + fp32 master; activations excluded):"]
    lines.append(f"{'stage':>6} {'dp':>5} {'per-device':>12} {'per-host':>10}")
    for stage in stages:
        for dp in dp_sizes:
            est = estimate_zero_model_states_mem_needs(
                num_params, stage=stage, dp=dp)
            lines.append(f"{stage:>6} {dp:>5} "
                         f"{_fmt(est['device_bytes']):>12} "
                         f"{_fmt(est['host_bytes']):>10}")
    return "\n".join(lines)
