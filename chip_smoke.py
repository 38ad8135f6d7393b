"""Drives the PyTorch/CUDA port's serving and training paths on one NVIDIA GPU.

    python3 chip_smoke.py [--out results.json]

Phases (each raises on failure; the script then exits non-zero and
prints no result line):

1. build the port's CUDA kernels from ``deepspeed_tpu_torch/csrc``;
2. hold each serving kernel against its plain PyTorch version on the
   card at the serving path's shapes (decode, a two-query chunk, a chunk
   that is no multiple of the query tile, a 512-token prefill chunk; fp32,
   bf16 and int8 pages; band attention for 8 and 1024 queries; and,
   untimed, head dim 128 with 48-token pages and head dim 64 with 5-token
   pages for decode, head dims 64 and 128 with 128- and 48-token pages for
   the band, there with queries at position 0, inside the first page and
   at a page's first and last tokens), and time kernel, plain version, one
   PyTorch library call computing the same attention (a yardstick only),
   and the least time the card could take (the bound); then show bit for
   bit that a query's output does not depend on the batch, the table
   width or the chunk around it (for the band: a query alone equals its
   row among 8 and among all the case's queries), and that a one-token
   prompt's prefill alone equals its row of a bucket-wide prefill chunk;
3. serve GPT-2 XL at full width (random weights from seed 0, bf16) with
   the continuous-batching engine on the kernel backends, and show that
   both kernels launched;
4. at full width in fp32, hold every served request's greedy tokens
   against the one-shot ``generate()`` on the same backend;
5. hold the three flash-attention kernels (forward, dq, dk/dv/dbias)
   against their plain versions at the BERT-large training shapes (bf16
   and fp32, padded keys, causal, a block-16 sparse layout with an empty
   row, dropout 0.1 on the same Philox bits; head dims 128 and 32 and
   longer sequences in blocks of 64 and 32 once each; fp16 padded with
   dropout, causal, head dim 128 and S = 512 in blocks of 64), and time
   them as phase 2 does, with ``scaled_dot_product_attention`` and its
   backward as the yardsticks (dq + dk/dv beside the whole backward);
   then an fp16 backward with dO times a loss scale near fp16's range,
   where kernels and plain versions must overflow in the same grads;
6. train BERT-large at full width through ``initialize()`` (Adam, bf16,
   ZeRO 0, activation checkpointing "dots", micro-batch 64, seq 128,
   dropout 0.1) on one repeated random batch, show that all three flash
   kernels launched, that every loss is finite and that the loss falls,
   and profile one step (bf16 dq must run on the tensor-core kernel);
   then train it in fp16 with LAMB, gradient clipping, WarmupDecayLR and
   dynamic loss scaling over ``training_data=`` through ``train_batch()``:
   the fp16 kernels must launch 48/24/24 times a step, the loss fall and
   every step run at the schedule's LR (held on a skipped step);
7. at BERT-large width with 2 layers and dropout 0.1, in fp32, bf16 and
   fp16, hold the loss and every parameter's gradient on the kernels
   against the same model with the plain attention versions swapped in;
8. (``zero``) hold the host Adam of ZeRO-Offload (``csrc/cpu_adam.cpp``,
   built by g++) against its plain version bit for bit on this machine's
   CPU at BERT-large's 336,232,258 elements, and time it beside its plain
   version, ``torch._fused_adamw_`` and its bound (28 bytes an element
   at the fastest of four host memory streams); start NCCL at world 1
   and train phase 6's bf16 Adam BERT-large 3 steps at ZeRO stages 0, 0
   again, 1, 2 and 3 and ZeRO-2 + ``cpu_offload`` sequential and
   streamed (4 buckets) under deterministic algorithms: each stage's
   losses and final masters must equal stage 0's, and streamed
   sequential's, bit for bit; then, under the default algorithms,
   stage 0, offload sequential and offload streamed, 3 warm-up and 10
   timed steps each: the loss must fall, peak device memory under
   offload stay below stage 0's, and the flash kernels launch 48/24/24
   times a step; last, report whether stage 0 run twice under the
   default algorithms agrees with itself, and which embedding-backward
   kernels each mode launches.

``--phases`` runs a subset (kernels, serve, oracle, flash, train, grad,
zero) while a kernel is being worked on; such a run prints no result
line.

The line before the last is the kernels' JSON, with the card's name and
power limit printed before it; the last line is the run's JSON result.
"""

import argparse
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12                  # H100 SXM
PEAK_OPS = {torch.float32: 67e12,          # fp32 outside the tensor cores
            torch.bfloat16: 989e12,        # bf16 tensor cores, dense
            torch.float16: 989e12}         # fp16 tensor cores, dense

B, NH, HD, PT, MP = 8, 25, 64, 128, 8      # GPT-2 XL serving shapes
W = 2 * PT                                  # band window (SPARSE_BAND + 1 pages)
PROMPT_LENS = (16, 40, 100, 200, 300, 480, 700, 900)
NEW_TOKENS = 32
# (atol, rtol) of kernel vs plain version. fp32: the same math in another
# summation order. bf16: the plain version rounds QK to bf16 before the
# softmax (as the TPU kernel does), the kernel keeps it in fp32. int8: both
# sides do the same fp32 math on the same pages and scales, so they differ
# by at most one bf16 step of the rounded output (2**-7 relative).
TOL = {"fp32": (1e-5, 1e-5), "bf16": (2e-2, 2e-2), "int8": (1e-3, 2.0 ** -7)}
SERVING_KERNELS = ("decode_attention", "sparse_attention")


def card_info():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


class Timer:
    """Median CUDA-event time of a callable, L2 flushed before each run
    (the serving step streams a layer's weights between two attention
    calls, so the kernel finds the cache cold). The card spins for about
    a millisecond before the first event, so the host has enqueued the
    callable's launches by the time the card reaches them and the events
    bracket device time, not the host's time to launch."""

    SPIN_CYCLES = 2_000_000

    def __init__(self):
        self._flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, iters=20, warmup=3):
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(iters):
            self._flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(self.SPIN_CYCLES)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def _check(name, got, want, tol):
    torch.cuda.synchronize()
    atol, rtol = tol
    err = (got.float() - want.float()).abs()
    bad = err > atol + rtol * want.float().abs()
    if not torch.isfinite(got.float()).all() or bool(bad.any()):
        raise RuntimeError(f"{name}: kernel disagrees with its plain version "
                           f"(max abs err {float(err.max()):.3e}, atol {atol}, "
                           f"rtol {rtol})")
    return float(err.max()), float(want.float().abs().max())


def _bound(nbytes, ops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _decode_inputs(C, kv, shape, padded_query=False):
    """Queries, a page pool, shuffled page tables and positions for one
    decode-kernel case; ``shape`` is (lanes, heads, head dim, page tokens,
    pages per lane)."""
    B, NH, HD, PT, MP = shape
    gen = torch.Generator(device="cuda").manual_seed(1000 + C)
    qdt = torch.float32 if kv == "fp32" else torch.bfloat16
    P = B * MP + 1
    q = torch.randn(B, C, NH, HD, generator=gen, device="cuda").to(qdt)
    pk32 = torch.randn(P, NH, PT, HD, generator=gen, device="cuda")
    pv32 = torch.randn(P, NH, PT, HD, generator=gen, device="cuda")
    ks = vs = None
    if kv == "int8":
        # every (page, head) at its own magnitude, 0.1 to 10, so a kernel
        # that reads another page's or head's scale, or swaps the K and V
        # scales, lands far outside the tolerance
        pk32 = pk32 * 0.1 * 100.0 ** torch.rand(P, NH, 1, 1, generator=gen, device="cuda")
        pv32 = pv32 * 0.1 * 100.0 ** torch.rand(P, NH, 1, 1, generator=gen, device="cuda")
        ks = pk32.abs().amax(dim=(2, 3)) / 127.0
        vs = pv32.abs().amax(dim=(2, 3)) / 127.0
        pk = torch.round(pk32 / ks[:, :, None, None]).clamp(-127, 127).to(torch.int8)
        pv = torch.round(pv32 / vs[:, :, None, None]).clamp(-127, 127).to(torch.int8)
    else:
        pk, pv = pk32.to(qdt), pv32.to(qdt)
    perm = torch.randperm(P - 1, generator=gen, device="cuda") + 1
    tables = perm.reshape(B, MP).to(torch.int32)
    if C == 1:     # decode: each lane at its own position
        qpos = torch.randint(0, MP * PT, (B, 1), generator=gen, device="cuda")
    elif C < 128:  # a short chunk somewhere in each lane's cache
        start = torch.randint(0, MP * PT - C, (B, 1), generator=gen, device="cuda")
        qpos = start + torch.arange(C, device="cuda")[None]
    else:          # a prefill chunk from position 0
        qpos = torch.arange(C, device="cuda").expand(B, C)
    qpos = qpos.to(torch.int32).contiguous()
    if padded_query:   # a query that sees no key: its output is 0
        qpos[0, 0] = -1
    return (q, pk, pv, tables, qpos, PT, qdt, ks, vs)


# shapes the serving path does not use but the kernel takes: head dim 128,
# pages that are no power of two (splits of several pages, a ragged last
# split and key block), tiny pages; (lanes, heads, head dim, page tokens, pages)
ODD_SHAPES = ((3, 4, 128, 48, 11), (2, 3, 64, 5, 60))


def decode_odd_case(C, kv, shape):
    """Kernel against plain version, and the bitwise invariance, at a
    shape off the serving path (checked, not timed)."""
    from deepspeed_tpu_torch.kernels import decode_attention as da

    args = _decode_inputs(C, kv, shape, padded_query=C > 1)
    label = f"C={C} pages={kv} shape={shape}"
    err, _ = _check(f"decode_attention {label}", da._decode_attend_cuda(*args),
                    da._decode_attend_torch(*args), TOL[kv])
    return dict(case=label, max_abs_err=err, tol=TOL[kv],
                invariance=decode_invariance(args, label))


def decode_one_token_prefill(kv, shape):
    """A one-token prompt in both callers' shapes: its prefill alone (C = 1,
    as ``generate()`` calls it) holds the plain version and equals, bit for
    bit, its row of the bucket-wide chunks that serving prefills it in."""
    from deepspeed_tpu_torch.kernels import decode_attention as da

    args = _decode_inputs(1, kv, shape)
    q, pk, pv, tables, qpos, pt, qdt, ks, vs = args
    qpos[0, 0] = 0                 # lane 0: the prompt's own position
    label = f"one-token prefill pages={kv} shape={shape}"
    alone = da._decode_attend_cuda(*args, prefill=True)
    err, _ = _check(f"decode_attention {label}", alone,
                    da._decode_attend_torch(*args), TOL[kv])
    last = tables.shape[1] * pt - 1
    for wide in (8, 128):
        qw = torch.zeros(q.shape[0], wide, *q.shape[2:], dtype=q.dtype, device="cuda")
        qw[:, :1] = q
        qposw = (qpos + torch.arange(wide, device="cuda", dtype=torch.int32))
        qposw = qposw.clamp(max=last).contiguous()
        chunk = da._decode_attend_cuda(qw, pk, pv, tables, qposw, pt, qdt, ks, vs,
                                       prefill=True)
        if not torch.equal(chunk[:, :1], alone):
            raise RuntimeError(f"decode_attention {label}: the prefill alone differs "
                               f"from its row of a chunk of {wide}")
    torch.cuda.synchronize()
    return dict(case=label, max_abs_err=err, tol=TOL[kv], invariance=2)


def decode_case(timer, C, kv):
    from deepspeed_tpu_torch.kernels import decode_attention as da

    args = _decode_inputs(C, kv, (B, NH, HD, PT, MP))
    q, pk, pv, tables, qpos, _, qdt, ks, vs = args
    got = da._decode_attend_cuda(*args)
    want = da._decode_attend_torch(*args)
    err, out_absmax = _check(f"decode_attention C={C} {kv}", got, want, TOL[kv])
    ms = timer(lambda: da._decode_attend_cuda(*args))
    plain_ms = timer(lambda: da._decode_attend_torch(*args), iters=5, warmup=1)

    # yardstick: SDPA over each lane's gathered (dequantized) pages, same mask
    def lane_kv(pages, scale):
        x = pages.float() * scale[:, :, None, None] if scale is not None else pages
        g = x.to(qdt)[tables.long()].transpose(1, 2)           # [B, nh, mp, pt, hd]
        return g.reshape(B, NH, MP * PT, HD).contiguous()

    K, V = lane_kv(pk, ks), lane_kv(pv, vs)
    mask = (torch.arange(MP * PT, device="cuda")[None, None, None, :]
            <= qpos.long()[:, None, :, None])
    qt = q.transpose(1, 2).contiguous()
    library_ms = timer(lambda: F.scaled_dot_product_attention(qt, K, V, attn_mask=mask))

    # the work this run's data needs: a lane's K and V rows 0 .. its last
    # query's position, the table entries and int8 scales of those pages,
    # and one QK and one PV product per (query, visible key, head)
    lane_keys = (qpos.long().amax(dim=1) + 1).clamp(max=MP * PT)
    pages_read = int(((lane_keys + PT - 1) // PT).sum())
    nbytes = (q.numel() * q.element_size() * 2 + qpos.numel() * 4 + pages_read * 4
              + int(lane_keys.sum()) * 2 * NH * HD * pk.element_size()
              + (pages_read * 2 * NH * 4 if ks is not None else 0))
    pairs = int((qpos.long() + 1).clamp(max=MP * PT).sum())
    bound_ms, bound_by = _bound(nbytes, pairs * NH * 4 * HD, qdt)
    return dict(case=f"C={C} pages={kv}", max_abs_err=err, out_absmax=out_absmax,
                tol=TOL[kv], ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by,
                invariance=decode_invariance(args, f"C={C} pages={kv}"))


def decode_invariance(args, label):
    """Bit for bit: every lane's output among the 8 lanes and the pool-wide
    table equals its output alone (B = 1, a table of just the pages it
    sees), and a chunk's rows equal the same rows of a wider chunk padded
    with zero queries. Returns the number of comparisons made."""
    from deepspeed_tpu_torch.kernels import decode_attention as da

    q, pk, pv, tables, qpos, pt, qdt, ks, vs = args
    B, C, NH, HD = q.shape
    last = tables.shape[1] * pt - 1
    full = da._decode_attend_cuda(*args)
    checks = 0
    for b in range(B):
        pages = int(qpos[b].max()) // pt + 1
        alone = da._decode_attend_cuda(q[b:b + 1].contiguous(), pk, pv,
                                       tables[b:b + 1, :pages].contiguous(),
                                       qpos[b:b + 1].contiguous(), pt, qdt, ks, vs)
        if not torch.equal(alone[0], full[b]):
            raise RuntimeError(f"decode_attention {label}: lane {b} alone differs from "
                               f"lane {b} among {B} lanes")
        checks += 1
    if C > 1:
        wide = C + 24
        qw = torch.zeros(B, wide, NH, HD, dtype=q.dtype, device="cuda")
        qw[:, :C] = q
        extra = qpos[:, -1:] + 1 + torch.arange(wide - C, device="cuda", dtype=torch.int32)
        qposw = torch.cat([qpos, extra.clamp(max=last)], dim=1).contiguous()
        padded = da._decode_attend_cuda(qw, pk, pv, tables, qposw, pt, qdt, ks, vs)
        if not torch.equal(padded[:, :C], full):
            raise RuntimeError(f"decode_attention {label}: the chunk's rows differ inside "
                               f"a chunk of {wide}")
        checks += 1
    torch.cuda.synchronize()
    return checks


def _band_inputs(N, dtype_name, shape=None, positions=None, seed=None):
    """Queries, window and sink slices, positions and window bases for one
    band-kernel case; ``shape`` is (heads, head dim, page tokens), and
    ``positions`` (else random over 8 pages) the queries' positions."""
    from deepspeed_tpu_torch.kernels import sparse_attention as sa

    nh, hd, pt = shape or (NH, HD, PT)
    dt = torch.float32 if dtype_name == "fp32" else torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(2000 + N if seed is None else seed)
    rnd = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(dt)
    q, kw, vw = rnd(N, nh, hd), rnd(N, nh, 2 * pt, hd), rnd(N, nh, 2 * pt, hd)
    ksk, vsk = rnd(N, nh, pt, hd), rnd(N, nh, pt, hd)
    if positions is None:
        pos = torch.randint(0, MP * pt, (N,), generator=gen, device="cuda")
    else:
        pos = torch.tensor(positions, device="cuda")
    base = sa._window_base(pos, pt)
    return (q, kw, vw, ksk, vsk, pos.to(torch.int32), base.to(torch.int32), dt)


def band_invariance(args, label):
    """Bit for bit: each of the first 8 queries alone equals its row among
    the first 8 and among all N. Returns the number of comparisons."""
    from deepspeed_tpu_torch.kernels import sparse_attention as sa

    rows = lambda a, i, j: [t[i:j].contiguous() for t in a[:7]] + [a[7]]
    full = sa._band_attend_cuda(*args)
    eight = sa._band_attend_cuda(*rows(args, 0, 8))
    checks = 0
    for i in range(min(8, args[0].shape[0])):
        alone = sa._band_attend_cuda(*rows(args, i, i + 1))
        for other, n in ((eight, 8), (full, args[0].shape[0])):
            if not torch.equal(alone[0], other[i]):
                raise RuntimeError(f"sparse_attention {label}: query {i} alone differs "
                                   f"from its row among {n}")
            checks += 1
    torch.cuda.synchronize()
    return checks


# band shapes the serving path does not use but the kernel takes, each with
# queries at the edges of the mask: position 0, inside the first page
# (base 0: no sink), the first token of a page, the last token of a page;
# (heads, head dim, page tokens)
BAND_ODD_SHAPES = ((NH, HD, PT), (4, 128, PT), (3, 64, 48), (2, 128, 48))


def band_odd_case(dtype_name, shape):
    """Kernel against plain version, and the bitwise invariance, for
    queries at the mask's edges (checked, not timed)."""
    from deepspeed_tpu_torch.kernels import sparse_attention as sa

    pt = shape[2]
    positions = [0, 1, pt - 1, pt, pt + 1, 2 * pt, 2 * pt - 1, 3 * pt, 5 * pt,
                 MP * pt - 1, 7 * pt, 4 * pt + 3]
    args = _band_inputs(len(positions), dtype_name, shape, positions, seed=2500 + pt)
    label = f"{dtype_name} shape={shape} edges"
    err, _ = _check(f"sparse_attention {label}", sa._band_attend_cuda(*args),
                    sa._band_attend_torch(*args), TOL[dtype_name])
    return dict(case=label, max_abs_err=err, tol=TOL[dtype_name],
                invariance=band_invariance(args, label))


def band_case(timer, N, dtype_name):
    from deepspeed_tpu_torch.kernels import sparse_attention as sa

    args = _band_inputs(N, dtype_name)
    q, kw, vw, ksk, vsk, pos, base, dt = args
    got = sa._band_attend_cuda(*args)
    want = sa._band_attend_torch(*args)
    err, out_absmax = _check(f"sparse_attention N={N} {dtype_name}", got, want,
                             TOL[dtype_name])
    ms = timer(lambda: sa._band_attend_cuda(*args))
    plain_ms = timer(lambda: sa._band_attend_torch(*args), iters=5, warmup=1)

    K = torch.cat([ksk, kw], dim=2)
    V = torch.cat([vsk, vw], dim=2)
    valid = torch.cat([torch.arange(PT, device="cuda")[None] < base.long()[:, None],
                       base.long()[:, None] + torch.arange(W, device="cuda")[None]
                       <= pos.long()[:, None]], dim=1)
    mask = valid[:, None, None, :]
    q4 = q[:, :, None, :]
    library_ms = timer(lambda: F.scaled_dot_product_attention(q4, K, V, attn_mask=mask))

    keys = int(valid.sum())
    item = q.element_size()
    nbytes = (2 * q.numel() * item + 2 * pos.numel() * 4
              + keys * 2 * NH * HD * item)
    bound_ms, bound_by = _bound(nbytes, keys * NH * 4 * HD, dt)
    return dict(case=f"N={N} {dtype_name}", max_abs_err=err, out_absmax=out_absmax,
                tol=TOL[dtype_name],
                ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                bound_by=bound_by,
                invariance=band_invariance(args, f"N={N} {dtype_name}") if N > 8 else 0)


def _prompts():
    rng = np.random.RandomState(0)
    return [rng.randint(0, 50257, n).tolist() for n in PROMPT_LENS]


def _engine(model, cfg, kv):
    from deepspeed_tpu_torch import ServingConfig, ServingEngine
    from deepspeed_tpu_torch.inference.serving.scheduler import default_buckets

    largest = default_buckets(cfg.max_position_embeddings - 1)[-1]
    scfg = ServingConfig(max_slots=B, max_seq_len=cfg.max_position_embeddings,
                         kv_cache_dtype=kv,
                         attention_impl={"default": "pallas_decode",
                                         largest: "pallas_sparse"})
    return ServingEngine(model, cfg, scfg, device="cuda")


def _drive(eng):
    """Submit the traffic to ``eng``, drain it, and return the outputs,
    each request's backend, and the pass's metrics."""
    from deepspeed_tpu_torch.inference.serving.metrics import ServingMetrics

    eng.metrics = ServingMetrics()
    futs = [eng.submit(p, max_new_tokens=NEW_TOKENS) for p in _prompts()]
    t0 = time.perf_counter()
    eng.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    snap = eng.metrics.snapshot()
    pass_ = dict(
        ttft_p50_s=snap["ttft_p50_s"], ttft_p95_s=snap["ttft_p95_s"],
        decode_tokens_per_s=snap["tokens_per_sec"],
        decode_step_ms=1e3 * snap["decode_time_s"] / max(snap["decode_steps"], 1),
        decode_steps=snap["decode_steps"], prefill_calls=snap["prefill_calls"],
        prefill_s=eng.metrics.prefill_time_s, wall_s=wall)
    outs = [f.result(timeout=0) for f in futs]
    impls = [eng._impl_for_len(len(p)) for p in _prompts()]
    return outs, impls, pass_


def _profiled(fn):
    """Run ``fn`` under the profiler: the window's host wall time, device
    time by kernel (names cut to 90 characters, times summed), the
    device's busy share of the wall time, and host self time by op."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    by_name, calls = {}, {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name[:90]
            by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us()
            calls[name] = calls.get(name, 0) + 1
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    host = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)[:10]
    return dict(wall_ms=wall_us / 1e3, device_busy_ms=busy / 1e3,
                busy_share=busy / wall_us if wall_us else None, kernels=len(by_name),
                top_ms={k: v / 1e3 for k, v in top},
                # the port's own kernels, whatever their rank
                own_ms={k: v / 1e3 for k, v in by_name.items() if "dstorch" in k},
                own_launches={k: v for k, v in calls.items() if "dstorch" in k},
                # host self time by op under the profiler (which inflates it)
                top_host_self_ms={a.key[:90]: a.self_cpu_time_total / 1e3 for a in host})


def _profile(eng):
    """Device time by kernel over one admission (all prefills) and over 8
    decode steps of the same traffic."""
    for p in _prompts():
        eng.submit(p, max_new_tokens=NEW_TOKENS)
    out = {}
    for window, steps in (("admission_step", 1), ("decode_8_steps", 8)):
        out[window] = _profiled(lambda: [eng.step() for _ in range(steps)])
    eng.drain()
    return out


def phase_serve():
    from deepspeed_tpu_torch import GPT2Config, init_gpt2, kernels

    cfg = GPT2Config.gpt2_xl()
    model = init_gpt2(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    eng = _engine(model, cfg, "bf16")
    _, _, cold = _drive(eng)        # first pass: one-time costs (cuBLAS, allocator)
    kernels.reset_launch_counts()
    outs, impls, warm = _drive(eng)  # the measured pass of the main path
    counts = kernels.launch_counts()
    for out in outs:
        if len(out) != NEW_TOKENS or not all(0 <= t < cfg.vocab_size for t in out):
            raise RuntimeError(f"bad served output {out}")
    counts = {k: counts[k] for k in SERVING_KERNELS}
    if min(counts.values()) <= 0:
        raise RuntimeError(f"a kernel of the path never launched: {counts}")
    res = dict(model="gpt2_xl bf16 (seed 0), kv bf16, 8 slots, max_seq_len 1024",
               prompt_lens=list(PROMPT_LENS), new_tokens=NEW_TOKENS, impls=impls,
               **warm, cold_pass=cold, launches=counts,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)
    res["profile"] = _profile(eng)
    del eng, model
    torch.cuda.empty_cache()
    return res


def _margins(model, cfg, prompt, impl):
    """Greedy tokens and the top-2 logit margin at every step of the
    one-shot path (the same functions ``generate()`` runs)."""
    from deepspeed_tpu_torch.inference import generation as g

    nh = cfg.num_attention_heads
    step = {"pallas_decode": g._step_kernel,
            "pallas_sparse": g._step_window_kernel}[impl]
    ids = torch.tensor([prompt], device="cuda")
    S = ids.shape[1]
    toks, margins = [], []
    with torch.no_grad():
        caches, logits = g._forward_full(model, ids, S, cfg.num_hidden_layers, nh,
                                         cfg.hidden_size // nh, S + NEW_TOKENS,
                                         attn_impl=impl, page_tokens=PT)
        for pos in range(S, S + NEW_TOKENS):
            top = torch.topk(logits.float(), 2, dim=-1).values[0]
            margins.append(float(top[0] - top[1]))
            tok = torch.argmax(logits, dim=-1)
            toks.append(int(tok))
            logits = step(model, nh, caches, tok, torch.full((1,), pos, device="cuda"), PT)
    return toks, margins


def phase_oracle():
    from deepspeed_tpu_torch import GPT2Config, generate, init_gpt2

    cfg = GPT2Config.gpt2_xl()
    model = init_gpt2(cfg, seed=0, device="cuda", dtype=torch.float32)
    outs, impls, _ = _drive(_engine(model, cfg, "fp32"))
    rows = []
    for prompt, out, impl in zip(_prompts(), outs, impls):
        want = generate(model, cfg, [prompt], NEW_TOKENS, attn_impl=impl,
                        kv_page_tokens=PT, device="cuda")[0].tolist()
        row = dict(prompt_len=len(prompt), impl=impl, equal=out == want)
        if out != want:
            first = next(i for i, (a, b) in enumerate(zip(out, want)) if a != b)
            toks, margins = _margins(model, cfg, prompt, impl)
            if toks != want:
                raise RuntimeError("one-shot replay does not reproduce generate()")
            row.update(first_divergence=first, top2_margin=margins[first])
            if margins[first] >= 1e-3:
                raise RuntimeError(f"served tokens diverge from generate() at step "
                                   f"{first} with top-2 margin {margins[first]:.3e}: "
                                   f"{row}")
        rows.append(row)
    del model
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# training: the flash-attention kernels (phase 5), BERT-large through
# initialize() (phase 6), and the gradient oracle (phase 7)
# ---------------------------------------------------------------------------

FB, FH, FS, FD = 64, 16, 128, 64           # BERT-large training shapes (B, heads, S, D)
FLASH_SEED = 4321
# kernel vs plain version, relative to the compared tensor's largest
# magnitude (at least 1). fp32: the same fp32 math summed in another order.
# bf16: both round p and ds to bf16 at the same points, but a different
# summation order can flip a rounding, and outputs are rounded to bf16.
# fp16: the same, with three more bits of mantissa (8x finer steps), so a
# quarter of bf16's tolerance.
FLASH_TOL = {"fp32": 1e-5, "bf16": 2e-2, "fp16": 5e-3}
FLASH_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16, "fp16": torch.float16}
FLASH_KERNELS = ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv")
FLASH_MAIN_CASE = "bf16 padded dropout0.1"
FLASH_FP16_MAIN_CASE = "fp16 padded dropout0.1"
TRAIN_WARMUP, TRAIN_STEPS = 3, 10


def _check_rel(name, got, want, tol):
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    scale = max(1.0, float(want.float().abs().max()))
    if not torch.isfinite(got.float()).all() or err > tol * scale:
        raise RuntimeError(f"{name}: kernel disagrees with its plain version (max abs err "
                           f"{err:.3e}, allowed {tol} x {scale:.3g})")
    return err


def _flash_work(lut, counts, qlut, qcounts, block, causal, elem, FD=FD, FB=FB, FS=FS):
    """Bytes and (query, key) pairs the three kernels need for these
    inputs: every visited query or key block read once (q, dO, lse and
    delta rows; k and v rows), outputs written once; a pair counts where
    its key block is on the query block's LUT row and, when causal,
    key <= query."""
    lut, counts = lut.cpu().numpy(), counts.cpu().numpy()
    qcounts = qcounts.cpu().numpy()
    pairs = 0
    for h in range(lut.shape[0]):
        for qi in range(lut.shape[1]):
            for kj in lut[h, qi, :counts[h, qi]]:
                if not causal or kj < qi:
                    pairs += block * block
                elif kj == qi:
                    pairs += block * (block + 1) // 2
    pairs *= FB
    q_rows = FB * int((counts > 0).sum()) * block
    k_rows = FB * int((qcounts > 0).sum()) * block
    all_rows = FB * FH * FS
    row = FD * elem
    bias = FB * FS * 4
    fwd = (q_rows + 2 * k_rows) * row + bias + all_rows * (row + 4)
    dq = (2 * q_rows) * row + q_rows * 8 + 2 * k_rows * row + bias + all_rows * row
    dkv = (2 * k_rows) * row + bias + 2 * q_rows * row + q_rows * 8 + all_rows * (2 * row + 4)
    return dict(fwd=(fwd, 4 * FD * pairs), dq=(dq, 6 * FD * pairs), dkv=(dkv, 8 * FD * pairs))


def flash_case(timer, label, dtype_name, *, causal=False, rate=0.0, padded=True,
               sparse=False, FD=FD, FB=FB, FS=FS, block=None):
    """Kernels 1-3 against their plain versions on one input set, each
    with its time, bound and SDPA yardstick; dq + dk/dv together beside
    SDPA's whole backward (PyTorch has no call that computes dq alone)."""
    from deepspeed_tpu_torch.ops.transformer import attention as fa

    dt = FLASH_DTYPES[dtype_name]
    block = 16 if sparse else block or fa.DEFAULT_BLOCK
    gen = torch.Generator(device="cuda").manual_seed(3000 + sum(map(ord, label)))
    q, k, v, do = (torch.randn(FB, FH, FS, FD, generator=gen, device="cuda").to(dt)
                   for _ in range(4))
    bias = torch.zeros(FB, FS, device="cuda")
    if padded:   # about a fifth of each row's keys padded away (key 0 kept)
        pad = torch.rand(FB, FS, generator=gen, device="cuda") < 0.2
        pad[:, 0] = False
        bias = torch.where(pad, -10000.0, 0.0)
    layout = None
    if sparse:
        nb = FS // block
        layout = (np.random.RandomState(5).rand(FH, nb, nb) < 0.5).astype(np.int64)
        layout[:, :, 0] = 1
        layout[0, 1, :] = 0          # head 0, query block 1 sees no key
    lut, counts, qlut, qcounts = fa._device_luts(layout, FH, FS, block, q.device)
    kw = dict(block=block, causal=causal, rate=rate, seed=FLASH_SEED)
    pkw = (block, causal, rate, FLASH_SEED)
    tol = FLASH_TOL[dtype_name]

    out, lse = fa.flash_fwd(q, k, v, bias, lut, counts, **kw)
    out_p, lse_p = fa._flash_fwd_torch(q, k, v, bias, lut, counts, *pkw)
    errs = dict(out=_check_rel(f"{label} out", out, out_p, tol),
                lse=_check_rel(f"{label} lse", lse, lse_p, FLASH_TOL["fp32"]))
    delta = (do.float() * out_p.float()).sum(-1).reshape(FB * FH, FS)
    bwd_in = (q, k, v, bias, do, lse_p, delta)
    dq = fa.flash_bwd_dq(*bwd_in, lut, counts, **kw)
    dq_p = fa._flash_bwd_dq_torch(*bwd_in, lut, counts, *pkw)
    errs["dq"] = _check_rel(f"{label} dq", dq, dq_p, tol)
    dkv = fa.flash_bwd_dkv(*bwd_in, qlut, qcounts, **kw)
    dkv_p = fa._flash_bwd_dkv_torch(*bwd_in, qlut, qcounts, *pkw)
    for name, got, want in zip(("dk", "dv", "db"), dkv, dkv_p):
        errs[name] = _check_rel(f"{label} {name}", got, want, tol)
    plain_absmax = {name: float(t.float().abs().max()) for name, t in
                    zip(("out", "lse", "dq", "dk", "dv", "db"), (out_p, lse_p, dq_p, *dkv_p))}
    if sparse and float(out[:, 0, block:2 * block].abs().max()) != 0.0:
        raise RuntimeError(f"{label}: the empty row's output is not 0")

    calls = {
        "fwd": (lambda: fa.flash_fwd(q, k, v, bias, lut, counts, **kw),
                lambda: fa._flash_fwd_torch(q, k, v, bias, lut, counts, *pkw)),
        "dq": (lambda: fa.flash_bwd_dq(*bwd_in, lut, counts, **kw),
               lambda: fa._flash_bwd_dq_torch(*bwd_in, lut, counts, *pkw)),
        "dkv": (lambda: fa.flash_bwd_dkv(*bwd_in, qlut, qcounts, **kw),
                lambda: fa._flash_bwd_dkv_torch(*bwd_in, qlut, qcounts, *pkw)),
    }
    # yardstick: SDPA over the same keys (the layout and the causal mask as
    # an additive mask; its dropout draws other bits), and its backward
    mask = bias[:, None, None, :]
    if sparse:
        dense = fa._expand_layout_mask(layout, FS, block).to("cuda")
        mask = mask + torch.where(dense, 0.0, -10000.0)[None]
    if causal:
        tril = torch.ones(FS, FS, dtype=torch.bool, device="cuda").tril()
        mask = mask + torch.where(tril, 0.0, -10000.0)
    mask = mask.to(dt)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    sdpa = lambda: F.scaled_dot_product_attention(*leaves, attn_mask=mask, dropout_p=rate)
    lib_fwd = timer(sdpa)
    o_lib = sdpa()
    lib_bwd = timer(lambda: torch.autograd.grad(o_lib, leaves, do, retain_graph=True))
    work = _flash_work(lut, counts, qlut, qcounts, block, causal, q.element_size(), FD, FB, FS)
    res = {}
    for kind, (kern, plain) in calls.items():
        bound_ms, bound_by = _bound(*work[kind], dt)
        res[kind] = dict(ms=timer(kern), plain_ms=timer(plain, iters=5, warmup=1),
                         library_ms=lib_fwd if kind == "fwd" else lib_bwd,
                         bound_ms=bound_ms, bound_by=bound_by)
    backward = dict(dq_plus_dkv_ms=res["dq"]["ms"] + res["dkv"]["ms"], library_ms=lib_bwd)
    return dict(case=label, block=block, head_dim=FD, batch=FB, seq=FS, causal=causal,
                dropout=rate, tol=tol, max_abs_err=errs, plain_absmax=plain_absmax,
                kernels=res, backward=backward)


FP16_MAX = 65504.0
OVERFLOW_LOSS_SCALE = 2.0 ** 14   # the largest power of two that keeps |dO| <= 2 finite


def flash_overflow_case():
    """An fp16 backward with dO multiplied by a loss scale near fp16's range
    (|dO| <= 2 before the scale, q tripled so the softmax is sharp and ds
    is large): the kernels and their plain versions round ds and the grads
    to fp16 at the same points, so both must give inf in the same grads
    (the loss scaler's overflow verdict), and their finite elements must
    agree. The same inputs at scale 1 must stay finite on both sides."""
    from deepspeed_tpu_torch.ops.transformer import attention as fa

    dt, block, rate = torch.float16, fa.DEFAULT_BLOCK, 0.1
    gen = torch.Generator(device="cuda").manual_seed(3999)
    q, k, v, do = (torch.randn(FB, FH, FS, FD, generator=gen, device="cuda")
                   for _ in range(4))
    q, k, v = (q * 3).to(dt), k.to(dt), v.to(dt)
    do = do.clamp(-2.0, 2.0)
    pad = torch.rand(FB, FS, generator=gen, device="cuda") < 0.2
    pad[:, 0] = False
    bias = torch.where(pad, -10000.0, 0.0)
    lut, counts, qlut, qcounts = fa._device_luts(None, FH, FS, block, q.device)
    kw = dict(block=block, causal=False, rate=rate, seed=FLASH_SEED)
    pkw = (block, False, rate, FLASH_SEED)
    out_p, lse_p = fa._flash_fwd_torch(q, k, v, bias, lut, counts, *pkw)
    tol = FLASH_TOL["fp16"]
    res = dict(case="fp16 padded dropout0.1 loss-scaled dO", loss_scale=OVERFLOW_LOSS_SCALE,
               tol=tol, verdicts={})
    for scale in (1.0, OVERFLOW_LOSS_SCALE):
        dos = (do * scale).to(dt)
        if not torch.isfinite(dos.float()).all():
            raise RuntimeError("the scaled dO itself is not finite in fp16")
        delta = (dos.float() * out_p.float()).sum(-1).reshape(FB * FH, FS)
        bwd_in = (q, k, v, bias, dos, lse_p, delta)
        got = (fa.flash_bwd_dq(*bwd_in, lut, counts, **kw),
               *fa.flash_bwd_dkv(*bwd_in, qlut, qcounts, **kw)[:2])
        want = (fa._flash_bwd_dq_torch(*bwd_in, lut, counts, *pkw),
                *fa._flash_bwd_dkv_torch(*bwd_in, qlut, qcounts, *pkw)[:2])
        torch.cuda.synchronize()
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            gf, wf = g.float(), w.float()
            g_ok, w_ok = torch.isfinite(gf), torch.isfinite(wf)
            verdict = (not bool(g_ok.all()), not bool(w_ok.all()))
            if verdict[0] != verdict[1]:
                raise RuntimeError(f"fp16 overflow at loss scale {scale}: {name} "
                                   f"non-finite {verdict[0]} in the kernel, {verdict[1]} "
                                   "in the plain version")
            both = g_ok & w_ok
            differ = int((g_ok != w_ok).sum())
            if differ > 1e-5 * g.numel():
                raise RuntimeError(f"fp16 overflow at loss scale {scale}: {name} is finite "
                                   f"at {differ} elements on one side only")
            err = float((gf - wf).abs()[both].max()) if bool(both.any()) else 0.0
            big = max(1.0, float(wf.abs()[both].max())) if bool(both.any()) else 1.0
            if err > tol * big:
                raise RuntimeError(f"fp16 overflow at loss scale {scale}: finite {name} "
                                   f"differs by {err:.3e} (allowed {tol} x {big:.3g})")
            res["verdicts"][f"{name} x{scale:g}"] = dict(
                overflow=verdict[0], nonfinite=int((~g_ok).sum()),
                nonfinite_plain=int((~w_ok).sum()), finiteness_differs=differ,
                max_abs_err=err, finite_absmax=big)
    if any(v["overflow"] for k_, v in res["verdicts"].items() if k_.endswith("x1")):
        raise RuntimeError(f"fp16 backward overflowed at loss scale 1: {res['verdicts']}")
    if not any(v["overflow"] for v in res["verdicts"].values()):
        raise RuntimeError("the loss-scaled fp16 backward overflowed nowhere: the case "
                           "shows nothing")
    return res


def _bert_batch(cfg, batch, seq, seed=0):
    """Random ids with 15 % MLM labels and NSP labels, as bench.py makes them."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, cfg.vocab_size, (batch, seq))
    labels = np.where(rng.rand(batch, seq) < 0.15,
                      rng.randint(0, cfg.vocab_size, (batch, seq)), -1)
    nsp = rng.randint(0, 2, (batch,))
    as_t = lambda x: torch.as_tensor(x, dtype=torch.long, device="cuda")
    return (as_t(ids), as_t(np.zeros((batch, seq))), as_t(np.ones((batch, seq))),
            as_t(labels), as_t(nsp))


def phase_train():
    import deepspeed_tpu_torch as dt

    cfg = dt.BertConfig.bert_large(checkpoint_policy="dots")
    model = dt.init_bert(cfg, seed=0, device="cuda")
    ds_config = {"train_batch_size": FB, "train_micro_batch_size_per_gpu": FB,
                 "gradient_accumulation_steps": 1,
                 "optimizer": {"type": "Adam", "params": {"lr": 1e-4}},
                 "bf16": {"enabled": True}, "zero_optimization": {"stage": 0},
                 "activation_checkpointing": {"enabled": True}, "steps_per_print": 1000}
    engine, _, _, _ = dt.initialize(model=model, config=ds_config)
    n_params = sum(p.numel() for p in engine.module.parameters())
    batch = _bert_batch(cfg, FB, FS)
    losses = []
    for _ in range(TRAIN_WARMUP):
        losses.append(float(engine.train_step([batch])))
    torch.cuda.reset_peak_memory_stats()
    dt.kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed = [engine.train_step([batch]) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dt.kernels.launch_counts()
    losses += [float(x) for x in timed]
    flash = {k: counts[k] for k in FLASH_KERNELS}
    if min(flash.values()) <= 0:
        raise RuntimeError(f"a flash kernel never launched on the training path: {flash}")
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"non-finite training loss: {losses}")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"the loss did not fall on a repeated batch: {losses}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    profile = _profiled(lambda: engine.train_step([batch]))
    if not any("flash_bwd_dq_mma_kernel" in k for k in profile["own_ms"]):
        raise RuntimeError(f"bf16 dq did not run on the tensor cores: {profile['own_ms']}")
    res = dict(model="bert_large (seed 0), bf16 + fp32 masters, Adam lr 1e-4, ZeRO 0, "
                     "activation checkpointing 'dots', dropout 0.1/0.1",
               params=n_params, micro_batch=FB, seq=FS, warmup_steps=TRAIN_WARMUP,
               timed_steps=TRAIN_STEPS, step_ms=1e3 * wall / TRAIN_STEPS,
               samples_per_s=FB * TRAIN_STEPS / wall, losses=losses, peak_mem_gb=peak,
               launches=flash,
               launches_per_step={k: v / TRAIN_STEPS for k, v in flash.items()},
               profile_one_step=profile,
               # the profiler slows the host, so its window's busy share
               # understates the unprofiled step's
               busy_share_of_step=profile["device_busy_ms"] / (1e3 * wall / TRAIN_STEPS))
    del engine, model, timed
    torch.cuda.empty_cache()
    return res


# the fp16 run of phase 6: BERT-pretraining's LAMB recipe (the optimizer
# keys of DeepSpeedExamples' bing_bert LAMB config, seq 128) with a
# WarmupDecayLR schedule and dynamic loss scaling from 2**16
FP16_LAMB = {"type": "Lamb", "params": {"lr": 11e-3, "weight_decay": 0.01,
                                        "bias_correction": False, "max_coeff": 0.3,
                                        "min_coeff": 0.01}}
FP16_SCHEDULE = {"type": "WarmupDecayLR",
                 "params": {"warmup_min_lr": 0.0, "warmup_max_lr": 11e-3,
                            "warmup_num_steps": 10, "total_num_steps": 1000}}
FP16_KERNEL_NAMES = {"flash_attention_fwd": "flash_fwd_mma_kernel<__half",
                     "flash_attention_bwd_dq": "flash_bwd_dq_mma_kernel<__half",
                     "flash_attention_bwd_dkv": "flash_bwd_dkv_mma_kernel<__half"}
FLASH_PER_STEP = {"flash_attention_fwd": 48, "flash_attention_bwd_dq": 24,
                  "flash_attention_bwd_dkv": 24}   # 24 layers, recomputed forward


def _warmup_decay_lr(iteration, p):
    """WarmupDecayLR's LR at ``iteration``, written out (the schedule the
    engine must follow)."""
    warm = p["warmup_num_steps"]
    if iteration < warm:
        gamma = min(1.0, math.log(iteration + 1) / math.log(max(warm, 2)))
    else:
        gamma = max(0.0, (p["total_num_steps"] - iteration) / max(1.0, p["total_num_steps"] - warm))
    return p["warmup_min_lr"] + (p["warmup_max_lr"] - p["warmup_min_lr"]) * gamma


def phase_train_fp16():
    """BERT-large at full width in fp16 through ``initialize(training_data=)``
    and ``train_batch()``: LAMB on the fp32 masters, gradient clipping 1.0,
    WarmupDecayLR, dynamic loss scaling. Checks that the fp16 flash
    instantiations launch 48/24/24 times a step, that every loss is finite
    and the loss falls, and that each step runs at the schedule's LR, held
    on a skipped step."""
    import deepspeed_tpu_torch as dt

    cfg = dt.BertConfig.bert_large(checkpoint_policy="dots")
    model = dt.init_bert(cfg, seed=0, device="cuda")
    ds_config = {"train_batch_size": FB, "train_micro_batch_size_per_gpu": FB,
                 "gradient_accumulation_steps": 1, "optimizer": FP16_LAMB,
                 "scheduler": FP16_SCHEDULE, "gradient_clipping": 1.0,
                 "fp16": {"enabled": True, "loss_scale": 0, "initial_scale_power": 16},
                 "zero_optimization": {"stage": 0},
                 "activation_checkpointing": {"enabled": True}, "steps_per_print": 1000}
    # 256 samples (one tuple of tensors each) made as phase 6's batch is
    cols = [t.cpu() for t in _bert_batch(cfg, 4 * FB, FS, seed=0)]
    data = [tuple(c[i] for c in cols) for i in range(4 * FB)]
    engine, _, loader, _ = dt.initialize(model=model, config=ds_config, training_data=data)
    if engine.module.bert.embeddings.word_embeddings.weight.dtype != torch.float16:
        raise RuntimeError("the fp16 engine's module is not in fp16")
    sched = FP16_SCHEDULE["params"]
    clean, steps, losses = 0, [], []

    def step():
        nonlocal clean
        lr = engine.get_lr()[0]
        want = _warmup_decay_lr(clean, sched)
        if abs(lr - want) > 1e-12 * max(1.0, want):
            raise RuntimeError(f"step {len(steps)}: LR {lr}, the schedule says {want}")
        skipped, scale = engine.skipped_steps, engine.loss_scale()
        loss = engine.train_batch()
        overflow = engine.skipped_steps > skipped
        if overflow and engine.get_lr()[0] != lr:
            raise RuntimeError(f"step {len(steps)}: a skipped step moved the LR")
        clean += not overflow
        steps.append(dict(loss=loss, lr=lr, loss_scale=scale, overflow=overflow))
        losses.append(loss)

    for _ in range(TRAIN_WARMUP):
        step()
    torch.cuda.reset_peak_memory_stats()
    dt.kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dt.kernels.launch_counts()
    flash = {k: counts[k] for k in FLASH_KERNELS}
    per_step = {k: v / TRAIN_STEPS for k, v in flash.items()}
    if per_step != FLASH_PER_STEP:
        raise RuntimeError(f"fp16 flash launches a step {per_step}, not {FLASH_PER_STEP}")
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"non-finite fp16 training loss: {steps}")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"the fp16 loss did not fall: {steps}")
    if engine.skipped_steps == len(steps):
        raise RuntimeError(f"every fp16 step overflowed: {steps}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    profile = _profiled(lambda: engine.train_batch())
    for kernel, name in FP16_KERNEL_NAMES.items():
        got = sum(n for k, n in profile["own_launches"].items() if name in k)
        if got != FLASH_PER_STEP[kernel]:
            raise RuntimeError(f"{name}> launched {got} times in the profiled fp16 step, "
                               f"not {FLASH_PER_STEP[kernel]}: {profile['own_launches']}")
    res = dict(model="bert_large (seed 0), fp16 + fp32 masters, LAMB " +
                     json.dumps(FP16_LAMB["params"]) + ", WarmupDecayLR " + json.dumps(sched) +
                     ", gradient clipping 1.0, dynamic loss scale from 2^16, ZeRO 0, "
                     "activation checkpointing 'dots', dropout 0.1/0.1, training_data= "
                     f"{len(data)} synthetic samples (seed 0) through train_batch()",
               micro_batch=FB, seq=FS, warmup_steps=TRAIN_WARMUP, timed_steps=TRAIN_STEPS,
               step_ms=1e3 * wall / TRAIN_STEPS, samples_per_s=FB * TRAIN_STEPS / wall,
               steps=steps, skipped_steps=engine.skipped_steps,
               final_loss_scale=engine.loss_scale(), peak_mem_gb=peak, launches=flash,
               launches_per_step=per_step, loader_batches=len(loader),
               profile_one_step=profile,
               busy_share_of_step=profile["device_busy_ms"] / (1e3 * wall / TRAIN_STEPS))
    del engine, model
    torch.cuda.empty_cache()
    return res


class _PlainAttention:
    """Swap the flash kernel wrappers for their plain versions while
    active (the grad oracle's reference run), all but those named in
    ``keep`` (a subset of ``FLASH_KERNELS``)."""

    NAMES = dict(zip(FLASH_KERNELS, ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")))

    def __init__(self, keep=()):
        self.keep = keep

    def __enter__(self):
        from deepspeed_tpu_torch.ops.transformer import attention as fa

        self.saved = {attr: getattr(fa, attr) for attr in self.NAMES.values()}
        for kernel, attr in self.NAMES.items():
            if kernel not in self.keep:
                fn = getattr(fa, f"_{attr}_torch")
                setattr(fa, attr, lambda *a, block, causal, rate=0.0, seed=0, fn=fn:
                        fn(*a, block, causal, rate, seed))
        return self

    def __exit__(self, *exc):
        from deepspeed_tpu_torch.ops.transformer import attention as fa

        for attr, fn in self.saved.items():
            setattr(fa, attr, fn)


# phase 8: ZeRO and ZeRO-Offload at BERT-large width (the bf16 Adam run of
# phase 6 with only zero_optimization changed)
ZERO_STEPS = 3
OFFLOAD_BUCKETS = 4                         # the streamed run; 1 is sequential
CPU_ADAM_N = 336_232_258                    # BERT-large's parameters
CPU_ADAM_BYTES = 28                         # read p, g, m, v; write p, m, v (fp32)
CPU_ADAM_HP = dict(lr=1e-4, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.01)


def _host_ms(fns, iters):
    """Median host time of each of ``fns`` (name -> a CPU computation) over
    ``iters`` rounds after one warm-up round. A round runs each once, in
    turn, so that a change in the host's load falls on all of them."""
    times = {k: [] for k in fns}
    for i in range(iters + 1):
        for k, fn in fns.items():
            t0 = time.perf_counter()
            fn()
            if i:
                times[k].append((time.perf_counter() - t0) * 1e3)
    return {k: statistics.median(v) for k, v in times.items()}


def cpu_adam_case():
    """The host Adam kernel against its plain version on this machine's
    CPU at BERT-large's element count: one AdamW step from the same
    state, bit for bit; then the plain version's time (median of 3), and,
    in turns over 5 rounds, the kernel's, the kernel built without
    ``-ffp-contract=off``, ``torch._fused_adamw_`` on the CPU and four
    memory streams over the same arrays: a copy, an add, a sum and the
    fused AdamW again, each with its writes counted twice (write-allocate).
    The bound: 28 bytes an element at the fastest stream's rate."""
    import ctypes

    from deepspeed_tpu_torch.kernels import build
    from deepspeed_tpu_torch.ops.adam.cpu_adam import DeepSpeedCPUAdam, cpu_adam_reference

    n, hp = CPU_ADAM_N, CPU_ADAM_HP
    gen = torch.Generator().manual_seed(7)
    p0 = torch.randn(n, generator=gen)
    grad = torch.randn(n, generator=gen) * 1e-2
    opt = DeepSpeedCPUAdam(lr=hp["lr"], betas=(hp["beta1"], hp["beta2"]), eps=hp["eps"],
                           weight_decay=hp["weight_decay"])
    master = p0.clone()
    opt.init_host(master)
    ref, m, v = p0.clone(), torch.zeros(n), torch.zeros(n)
    opt.step_host(master, grad)
    plain = dict(hp, adamw=True, bias_correction=True)
    cpu_adam_reference(ref, grad, m, v, step=1, **plain)
    st = opt._host_state
    err = max(float((master - ref).abs().max()), float((st.exp_avg - m).abs().max()),
              float((st.exp_avg_sq - v).abs().max()))
    if not (torch.equal(master, ref) and torch.equal(st.exp_avg, m)
            and torch.equal(st.exp_avg_sq, v)):
        raise RuntimeError(f"cpu_adam differs from its plain version (max |err| {err})")
    steps = iter(range(2, 100))
    plain_ms = _host_ms({"plain": lambda: cpu_adam_reference(ref, grad, m, v,
                                                             step=next(steps), **plain)},
                        3)["plain"]
    lib_fast = build.load_host_library(tuple(f for f in build.HOST_FLAGS
                                             if f != "-ffp-contract=off"))
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    dst = torch.empty_like(p0)
    fns = {"kernel": lambda: opt.step_host(master, grad),
           "contracted_build": lambda: lib_fast.ds_adam_step(
               ptr(ref), ptr(grad), ptr(m), ptr(v), n, hp["lr"], hp["beta1"], hp["beta2"],
               hp["eps"], hp["weight_decay"], 1, 1, 1),
           "copy": lambda: dst.copy_(p0), "add": lambda: torch.add(p0, grad, out=dst),
           "sum": lambda: p0.sum()}
    fused = lambda: torch._fused_adamw_(
        [p0], [grad], [m], [v], [], [torch.tensor(1.0)], lr=hp["lr"], beta1=hp["beta1"],
        beta2=hp["beta2"], weight_decay=hp["weight_decay"], eps=hp["eps"], amsgrad=False,
        maximize=False)
    try:
        fused()
    except (RuntimeError, NotImplementedError) as e:
        library_error = str(e)[:200]
    else:
        fns["fused_adamw"], library_error = fused, None
    ms = _host_ms(fns, 5)
    # the host's memory rate: the fastest stream over arrays of n fp32, each
    # counted by the bytes it moves: an array read once, an array written
    # twice (a store to a line not in the cache first reads it)
    stream_bytes = {"copy": 3 * n * 4, "add": 4 * n * 4, "sum": n * 4,
                    "fused_adamw": (4 + 2 * 3) * n * 4}
    rates = {k: b / (ms[k] / 1e3) for k, b in stream_bytes.items() if k in ms}
    rate_from = max(rates, key=rates.get)
    del dst, p0, grad, master, m, v, ref
    return dict(case=f"AdamW step of {n} fp32 elements", max_abs_err=err, ms=ms["kernel"],
                plain_ms=plain_ms, library_ms=ms.get("fused_adamw"),
                library_error=library_error, contracted_build_ms=ms["contracted_build"],
                host_bytes_per_s=rates[rate_from], host_rate_from=rate_from,
                host_stream_ms={k: ms[k] for k in rates}, host_stream_bytes_per_s=rates,
                bound_ms=CPU_ADAM_BYTES * n / rates[rate_from] * 1e3, bound_by="bytes",
                threads=torch.get_num_threads())


def _pinned_rates():
    """D2H and H2D between the card and pinned host memory, 1 GiB, device
    time by CUDA events, median of 5."""
    dev = torch.empty(2 ** 28, device="cuda")
    host = torch.empty(2 ** 28, pin_memory=True)
    rates = {}
    for name, (dst, src) in {"d2h": (host, dev), "h2d": (dev, host)}.items():
        times = []
        for _ in range(6):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            dst.copy_(src, non_blocking=True)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        rates[f"{name}_bytes_per_s"] = 2 ** 30 / (statistics.median(times[1:]) / 1e3)
    return rates


def _zero_engine(**zero):
    """BERT-large bf16 Adam as phase 6 trains it, with ``zero``."""
    import deepspeed_tpu_torch as dt

    cfg = dt.BertConfig.bert_large(checkpoint_policy="dots")
    model = dt.init_bert(cfg, seed=0, device="cuda")
    ds_config = {"train_batch_size": FB, "train_micro_batch_size_per_gpu": FB,
                 "gradient_accumulation_steps": 1,
                 "optimizer": {"type": "Adam", "params": {"lr": 1e-4}},
                 "bf16": {"enabled": True}, "zero_optimization": zero,
                 "activation_checkpointing": {"enabled": True}, "steps_per_print": 1000}
    engine, _, _, _ = dt.initialize(model=model, config=ds_config)
    return engine, _bert_batch(cfg, FB, FS)


def _free(engine):
    close = getattr(engine.optimizer, "close", None)
    if close is not None:
        close()
    del engine
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def phase_zero():
    """Phase 8: the host Adam kernel against its plain version; under
    deterministic algorithms, 3 steps of ZeRO stages 1, 2 and 3 through
    NCCL at world 1 against stage 0 (and stage 0 against itself, the
    control), and of ZeRO-2 + cpu_offload streamed against sequential, bit
    for bit; then under the default algorithms stage 0, offload
    sequential and offload streamed, 3 warm-up and 10 timed steps each:
    losses finite and falling, peak device memory under offload below
    stage 0's, the flash kernels' and the host Adam's launches."""
    import tempfile

    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.runtime.zero import mem_estimator

    res = {"cpu_adam": _report("cpu_adam_case", cpu_adam_case())}
    failures = []
    with tempfile.TemporaryDirectory() as tmp:
        store = torch.distributed.FileStore(os.path.join(tmp, "store"), 1)
        torch.distributed.init_process_group("nccl", store=store, rank=0, world_size=1)
        try:
            res["backend"] = torch.distributed.get_backend()
            # bit-for-bit comparisons of whole runs: PyTorch's deterministic
            # algorithms (with cuBLAS's fixed workspaces, set in main)
            torch.use_deterministic_algorithms(True)
            try:
                res["bit_for_bit"] = _zero_equalities(failures)
            finally:
                torch.use_deterministic_algorithms(False)
            res["timed"] = _zero_timed(dt, failures)
            res["default_algorithms"] = _default_algorithms_probe()
        finally:
            torch.distributed.destroy_process_group()
    res["mem_estimate_gb"] = {
        name: {k: v / 2 ** 30 for k, v in mem_estimator.estimate_zero_model_states_mem_needs(
            CPU_ADAM_N, **kw).items() if k != "breakdown"}
        for name, kw in (("stage0", dict(stage=0)), ("stage2", dict(stage=2)),
                         ("offload_seq", dict(stage=2, cpu_offload=True)),
                         ("offload_stream", dict(stage=2, cpu_offload=True,
                                                 offload_stream_buckets=OFFLOAD_BUCKETS)))}
    res["pinned"] = _pinned_rates()
    res["failures"] = failures
    if failures:    # every check of the phase ran; any failure fails it
        print("zero", json.dumps(res), flush=True)
        raise RuntimeError("phase zero failed: " + "; ".join(failures))
    return res


OFFLOAD_SEQUENTIAL = dict(stage=2, cpu_offload=True, offload_stream_buckets=1)
OFFLOAD_STREAMED = dict(stage=2, cpu_offload=True, offload_stream_buckets=OFFLOAD_BUCKETS)


def _host_masters(engine):
    """A host copy of the engine's fp32 masters, by name."""
    return {k: v.to("cpu", copy=True) for k, v in engine.master_params().items()}


def _zero_equalities(failures):
    """ZERO_STEPS steps of each run from the same weights and batch; each
    run's losses and final fp32 masters against its reference's."""
    runs = {}
    for label, zero in (("stage0", dict(stage=0)), ("stage0_again", dict(stage=0)),
                        ("stage1", dict(stage=1)), ("stage2", dict(stage=2)),
                        ("stage3", dict(stage=3)), ("offload_sequential", OFFLOAD_SEQUENTIAL),
                        ("offload_streamed", OFFLOAD_STREAMED)):
        engine, batch = _zero_engine(**zero)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses = [float(engine.train_step([batch])) for _ in range(ZERO_STEPS)]
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        runs[label] = (losses, _host_masters(engine), peak)
        _free(engine)
    out = {}
    for label, against in (("stage0_again", "stage0"), ("stage1", "stage0"),
                           ("stage2", "stage0"), ("stage3", "stage0"),
                           ("offload_streamed", "offload_sequential")):
        (losses, master, peak), (want_losses, want_master, _) = runs[label], runs[against]
        diff = {k: float((master[k] - w).abs().max()) for k, w in want_master.items()
                if not torch.equal(master[k], w)}
        same = losses == want_losses and not diff
        worst = sorted(diff.items(), key=lambda kv: -kv[1])[:5]
        out[label] = dict(against=against, equal=same, losses=losses, peak_mem_gb=peak,
                          params_differing=len(diff), worst_param_diffs=worst)
        if not same:
            failures.append(f"{label} differs from {against}: losses {losses} against "
                            f"{want_losses}, {len(diff)} masters differ, {worst}")
    out["stage0"] = dict(losses=runs["stage0"][0], peak_mem_gb=runs["stage0"][2])
    return out


def _embedding_backward_kernels(engine, batch):
    """The CUDA kernels of one training step whose names mark the
    embedding tables' backward (``compute_grad_weight*``, ``sum_and_scatter``),
    with their launch counts."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        engine.train_step([batch])
        torch.cuda.synchronize()
    names = {}
    for e in prof.events():
        m = re.search(r"(compute_grad_weight\w*|sum_and_scatter|krn_partial_to_segment_idx)",
                      e.name)
        if e.device_type == torch.autograd.DeviceType.CUDA and m:
            names[m.group(1)] = names.get(m.group(1), 0) + 1
    return names


def _default_algorithms_probe():
    """Report only: why the bit-for-bit runs use deterministic algorithms.
    Stage 0 twice under the default algorithms (ZERO_STEPS steps each from
    the same weights and batch: do the runs agree?), and the embedding
    backward's kernels in a step under each mode."""
    runs, kernels = [], {}
    for _ in range(2):
        engine, batch = _zero_engine(stage=0)
        losses = [float(engine.train_step([batch])) for _ in range(ZERO_STEPS)]
        runs.append((losses, _host_masters(engine)))
        if len(runs) == 2:
            kernels["default"] = _embedding_backward_kernels(engine, batch)
            torch.use_deterministic_algorithms(True)
            try:
                kernels["deterministic"] = _embedding_backward_kernels(engine, batch)
            finally:
                torch.use_deterministic_algorithms(False)
        _free(engine)
    (la, ma), (lb, mb) = runs
    diff = {k: float((mb[k] - w).abs().max()) for k, w in ma.items() if not torch.equal(mb[k], w)}
    return dict(stage0_twice_equal=la == lb and not diff, losses=[la, lb],
                params_differing=sorted(diff.items(), key=lambda kv: -kv[1])[:5],
                embedding_backward_kernels=kernels)


def _zero_timed(dt, failures):
    """Stage 0, offload sequential and offload streamed under the default
    algorithms, in that order: TRAIN_WARMUP steps, then TRAIN_STEPS timed
    on the host clock (synchronized)."""
    out = {}
    for label, zero in (("stage0", dict(stage=0)), ("sequential", OFFLOAD_SEQUENTIAL),
                        ("streamed", OFFLOAD_STREAMED)):
        offload = zero.get("cpu_offload", False)
        engine, batch = _zero_engine(**zero)
        losses = [float(engine.train_step([batch])) for _ in range(TRAIN_WARMUP)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        dt.kernels.reset_launch_counts()
        stats, timed = [], []
        t0 = time.perf_counter()
        for _ in range(TRAIN_STEPS):
            timed.append(engine.train_step([batch]))
            if offload:
                stats.append(dict(engine.optimizer.last_offload_stats))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts, host_counts = dt.kernels.launch_counts(), dt.kernels.host_launch_counts()
        losses += [float(x) for x in timed]
        run = out[label] = dict(
            zero=zero, step_ms=1e3 * wall / TRAIN_STEPS, samples_per_s=FB * TRAIN_STEPS / wall,
            losses=losses, peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
            launches={k: counts[k] for k in FLASH_KERNELS},
            cpu_adam_launches=host_counts["cpu_adam"])
        if offload:
            run.update(offload_stats_mean={k: statistics.mean(s[k] for s in stats)
                                           for k in stats[0]},
                       offload_stats_last=stats[-1])
        _free(engine)
        if run["launches"] != {k: v * TRAIN_STEPS for k, v in FLASH_PER_STEP.items()}:
            failures.append(f"timed {label}: flash launches {run['launches']}")
        if offload and run["cpu_adam_launches"] <= 0:
            failures.append(f"offload {label}: the host Adam never launched")
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            failures.append(f"timed {label}: losses {losses}")
        if offload and not run["peak_mem_gb"] < out["stage0"]["peak_mem_gb"]:
            failures.append(f"offload {label}: peak {run['peak_mem_gb']} GiB not below "
                            f"stage 0's {out['stage0']['peak_mem_gb']}")
    out["step_over_stage0"] = {k: out[k]["step_ms"] / out["stage0"]["step_ms"]
                               for k in ("sequential", "streamed")}
    return out


PHASES = ("kernels", "serve", "oracle", "flash", "train", "grad", "zero")


def _report(tag, result):
    print(tag, json.dumps(result), flush=True)
    return result


def _phase(name, fn, *args):
    t0 = time.perf_counter()
    result = fn(*args)
    print(f"phase {name}: {time.perf_counter() - t0:.1f} s", flush=True)
    return result


def phase_kernels(timer):
    """Phase 2; every case is printed as soon as it has passed."""
    serving = (B, NH, HD, PT, MP)
    decode_cases = [_report("case", decode_case(timer, C, kv)) for C in (1, 2, 40, 512)
                    for kv in ("fp32", "bf16", "int8")]
    band_cases = [_report("case", band_case(timer, N, dt)) for N in (8, 8 * PT)
                  for dt in ("fp32", "bf16")]
    band_cases += [_report("case", band_odd_case(dt, shape)) for shape in BAND_ODD_SHAPES
                   for dt in ("fp32", "bf16")]
    odd_cases = [_report("case", decode_odd_case(C, kv, shape)) for shape in ODD_SHAPES
                 for C in (1, 5, 70) for kv in ("fp32", "bf16", "int8")]
    odd_cases += [_report("case", decode_one_token_prefill(kv, shape))
                  for shape in (serving,) + ODD_SHAPES for kv in ("bf16", "int8")]
    return decode_cases, band_cases, odd_cases


def phase_flash(timer):
    """Phase 5; every case is printed as soon as it has passed."""
    cases = (
        dict(label="bf16 padded", dtype_name="bf16"),
        dict(label="fp32 padded", dtype_name="fp32"),
        dict(label="bf16 causal", dtype_name="bf16", causal=True, padded=False),
        dict(label="bf16 block16 sparse empty-row", dtype_name="bf16", sparse=True),
        dict(label=FLASH_MAIN_CASE, dtype_name="bf16", rate=0.1),
        dict(label="fp32 causal dropout0.1", dtype_name="fp32", causal=True, rate=0.1),
        # the tile code differs by head dim
        dict(label="bf16 D128 causal dropout0.1", dtype_name="bf16", causal=True, rate=0.1,
             FD=128),
        dict(label="bf16 D32 padded", dtype_name="bf16", FD=32),
        # several LUT blocks a row or column: the forward's and dq's K/V ring
        # runs with both stages, dk/dv walks several query blocks
        dict(label="bf16 S512 block64 causal dropout0.1", dtype_name="bf16", causal=True,
             rate=0.1, FB=8, FS=512, block=64),
        dict(label="bf16 S256 block32 padded", dtype_name="bf16", FB=8, FS=256, block=32),
        # fp16, the loss-scaled training path's routines
        dict(label=FLASH_FP16_MAIN_CASE, dtype_name="fp16", rate=0.1),
        dict(label="fp16 causal", dtype_name="fp16", causal=True, padded=False),
        dict(label="fp16 D128 causal dropout0.1", dtype_name="fp16", causal=True, rate=0.1,
             FD=128),
        dict(label="fp16 S512 block64 causal dropout0.1", dtype_name="fp16", causal=True,
             rate=0.1, FB=8, FS=512, block=64),
    )
    results = [_report("flash_case", flash_case(timer, **c)) for c in cases]
    return results, _report("flash_overflow", flash_overflow_case())


# loss and each gradient, kernels against plain versions, relative to the
# gradient's largest magnitude (the loss: to itself). fp32: the same fp32
# math summed in another order, the same masks. bf16: both sides round p,
# ds and the attention outputs to bf16, but in another summation order, so
# an element can land one bf16 step (2^-8 of it) apart, and such flips
# carry through two layers of bf16 GEMMs and layer norms; 2e-2 is five bf16
# steps of the largest magnitude, FLASH_TOL's bound for one kernel.
# fp16: the same flips at fp16's finer steps; 1e-2, half of bf16's, set
# before the first fp16 run.
GRAD_TOL = {"fp32": 1e-4, "bf16": 2e-2, "fp16": 1e-2}


def phase_grad_oracle(dtype_name):
    """BERT-large width, 2 layers, dropout 0.1, activation checkpointing
    "dots", weights in ``dtype_name``: loss and every grad on the kernels
    against the plain attention versions, at the same dropout seed (the
    same Philox masks and the same hidden-dropout generators)."""
    import deepspeed_tpu_torch as dt

    dtype = FLASH_DTYPES[dtype_name]
    tol = GRAD_TOL[dtype_name]
    cfg = dt.BertConfig.bert_large(num_hidden_layers=2, checkpoint_activations=True,
                                   checkpoint_policy="dots")
    model = dt.init_bert(cfg, seed=0, device="cuda", dtype=dtype)
    batch = _bert_batch(cfg, 8, FS, seed=1)

    def run():
        model.zero_grad(set_to_none=True)
        loss = model(*batch, dropout_seed=77)
        loss.backward()
        return loss.item(), {n: p.grad.detach().clone() for n, p in model.named_parameters()}

    before = dt.kernels.launch_counts()
    loss, grads = run()
    after = dt.kernels.launch_counts()
    if any(after[k] <= before[k] for k in FLASH_KERNELS):
        raise RuntimeError("the kernel run of the grad oracle launched no flash kernel")
    with _PlainAttention():
        loss_p, grads_p = run()

    def held(label, loss, grads):
        """The worst gradient error of a run against the plain run, and its
        parameter; raises past the tolerance."""
        worst, worst_name = 0.0, None
        for name, g in grads.items():
            want = grads_p[name].float()
            err = float((g.float() - want).abs().max()) / max(float(want.abs().max()), 1e-30)
            if err >= worst:
                worst, worst_name = err, name
            if not err <= tol:
                raise RuntimeError(f"{dtype_name} {label}: grad of {name} differs from the "
                                   f"plain run by {err:.3e} of its max (tolerance {tol})")
        if abs(loss - loss_p) > tol * abs(loss_p):
            raise RuntimeError(f"{dtype_name} {label}: loss {loss} differs from the plain "
                               f"run's {loss_p}")
        return worst, worst_name

    worst, worst_name = held("kernels", loss, grads)
    # each kernel alone among plain versions: which one moves the gradients
    by_kernel = {}
    for kernel in FLASH_KERNELS:
        with _PlainAttention(keep=(kernel,)):
            loss_k, grads_k = run()
        by_kernel[kernel] = dict(zip(("worst_rel_grad_err", "worst_param"),
                                     held(f"{kernel} alone", loss_k, grads_k)),
                                 loss=loss_k)
    del model
    torch.cuda.empty_cache()
    return dict(model=f"bert_large width, 2 layers, {dtype_name}, dropout 0.1, remat dots",
                batch=8, seq=FS, loss=loss, loss_plain=loss_p, params=len(grads),
                worst_rel_grad_err=worst, worst_param=worst_name, tol=tol,
                one_kernel_alone=by_kernel)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the results here (JSON)")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of %(default)s; a subset prints no result")
    args = ap.parse_args()
    phases = set(args.phases.split(","))
    if not phases <= set(PHASES):
        ap.error(f"--phases takes {PHASES}")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # read by cuBLAS when its first handle is made: fixed workspaces, so that
    # phase 8's runs under deterministic algorithms are reproducible
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from deepspeed_tpu_torch.kernels import build, registry

    t0 = time.perf_counter()
    build.load_library()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"(nvcc {build.build_seconds if build.build_seconds is not None else 'cached'})",
          flush=True)

    timer = Timer()
    if "kernels" in phases:
        decode_cases, band_cases, odd_cases = _phase("kernels", phase_kernels, timer)
    if "serve" in phases:
        served = _report("serve", _phase("serve", phase_serve))
    if "oracle" in phases:
        oracle = _report("oracle", _phase("oracle", phase_oracle))
    if "flash" in phases:
        flash_cases, flash_overflow = _phase("flash", phase_flash, timer)
    if "train" in phases:
        trained = _report("train", _phase("train", phase_train))
        trained_fp16 = _report("train_fp16", _phase("train fp16", phase_train_fp16))
    if "grad" in phases:
        grad_oracle = [_report("grad_oracle", _phase(f"grad {d}", phase_grad_oracle, d))
                       for d in ("fp32", "bf16", "fp16")]
    if "zero" in phases:
        zero = _report("zero", _phase("zero", phase_zero))
    if phases != set(PHASES):
        print(card_info())
        print(f"partial run ({sorted(phases)}): no result line")
        return 0

    entries = []
    for name, cases, main_case in (("decode_attention", decode_cases, "C=1 pages=bf16"),
                                   ("sparse_attention", band_cases, "N=8 bf16")):
        rep = next(c for c in cases if c["case"] == main_case)
        source, replaces = registry.KERNEL_SOURCES[name]
        entries.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=served["launches"][name],
            max_abs_err=max(c["max_abs_err"] for c in cases),
            ms=rep["ms"], plain_ms=rep["plain_ms"], bound_ms=rep["bound_ms"],
            bound_by=rep["bound_by"], library_ms=rep["library_ms"],
            main_case=main_case,
            cases=cases + (odd_cases if name == "decode_attention" else [])))
    outputs = {"fwd": ("out", "lse"), "dq": ("dq",), "dkv": ("dk", "dv", "db")}
    # the bf16 / fp32 routines (their launches from the bf16 Adam run), then
    # the fp16 instantiations (their launches from the fp16 LAMB run)
    for suffix, main_case, run, dtypes in (
            ("", FLASH_MAIN_CASE, trained, ("bf16", "fp32")),
            ("_fp16", FLASH_FP16_MAIN_CASE, trained_fp16, ("fp16",))):
        rep = next(c for c in flash_cases if c["case"] == main_case)
        cases = [c for c in flash_cases if c["case"].split()[0] in dtypes]
        for name, kind in zip(FLASH_KERNELS, ("fwd", "dq", "dkv")):
            source, replaces = registry.KERNEL_SOURCES[name]
            if suffix:
                source = source.replace(".cu", "_fp16.cu")
            entries.append(dict(
                name=name + suffix, route="cuda", source=source, replaces=replaces,
                launches=run["launches"][name],
                max_abs_err=max(c["max_abs_err"][o] for c in cases for o in outputs[kind]),
                **rep["kernels"][kind], main_case=main_case,
                library_call=("scaled_dot_product_attention" if kind == "fwd" else
                              "scaled_dot_product_attention backward (dq, dk, dv together)"),
                cases=[dict(case=c["case"], max_abs_err=c["max_abs_err"], **c["kernels"][kind])
                       for c in cases]))
            if kind == "dq":   # the two backward kernels against SDPA's whole backward
                entries[-1]["backward_by_case"] = [dict(case=c["case"], **c["backward"])
                                                   for c in cases]
            if suffix and kind != "fwd":
                entries[-1]["loss_scaled_overflow"] = flash_overflow["verdicts"]
    case = zero["cpu_adam"]
    source, replaces = registry.HOST_KERNEL_SOURCES["cpu_adam"]
    entries.append(dict(
        name="cpu_adam", route="cpp", source=source, replaces=replaces,
        launches=zero["timed"]["streamed"]["cpu_adam_launches"],
        max_abs_err=case["max_abs_err"], ms=case["ms"], plain_ms=case["plain_ms"],
        bound_ms=case["bound_ms"], bound_by=case["bound_by"], library_ms=case["library_ms"],
        device="host CPU (g++ -O3 -march=native -fopenmp, OpenMP threads)",
        main_case=case["case"],
        library_call="torch._fused_adamw_ on the CPU",
        contracted_build_ms=case["contracted_build_ms"]))
    card = card_info()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(card=card, kernels=entries, serve=served, oracle=oracle,
                           flash_cases=flash_cases, flash_overflow=flash_overflow,
                           train=trained, train_fp16=trained_fp16,
                           grad_oracle=grad_oracle, zero=zero, torch=torch.__version__,
                           cuda=torch.version.cuda), f,
                      indent=1)
    print(card)                  # name and power limit, as nvidia-smi gives them
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
