"""Continuous-batching serving engine over the paged KV pool.

Port of ``deepspeed_tpu/inference/serving/engine.py``. The decode loop
runs one masked batched step over the pool's ``max_slots`` lanes per
lane class; requests join and retire by flipping host-side lane state,
which is uploaded to the device only when lane membership changes. A
step reads the device once (the emitted tokens, or under speculation the
oracle tokens and the accepted counts).

Prefill is one batched causal forward per (bucket, backend): queued
requests that share a prompt bucket and attention backend are prefilled
together as a ``[max_slots, bucket]`` call into a prefill KV buffer that
is allocated once and reused, then installed into their pool pages.
Prompts longer than ``prefill_chunk_tokens`` are prefilled one chunk per
engine step into a private cache, between decode steps, and installed on
their last chunk. With ``prefix_cache_mb`` a prompt whose prefix was
served before seeds that prefix's KV from the host-side prefix cache
(prefix_cache.py) and prefills only its suffix.

Lane classes, by attention backend:

- ``dense`` (and ``flash``, whose decode is dense): each lane's pages are
  gathered into a contiguous stripe, the one-shot path's ``_decode_one``
  runs against it per layer, and the freshly written row goes back into
  its page;
- ``pallas_decode``: per layer the fresh row is written into its page and
  the pool itself (storage dtype, int8 included) goes to the paged
  decode-attention kernel through the lane page tables;
- ``pallas_sparse`` and ``sparse_xla``: per layer the fresh row is
  written, each lane's window pages and anchor page are gathered, and the
  band kernel (``sparse_xla``: its plain version, composed ops) runs.

Speculative decoding (``speculative_k`` > 0): each step drafts k tokens a
lane with the n-gram drafter over the lane's own history, verifies the
k+1 positions in one forward per class (the decode kernel at C = k+1 on
the pool for ``pallas_decode`` lanes, the band kernel over gathered
stripes for ``pallas_sparse``, composed ops for the rest) and emits the
accepted drafts plus the oracle's next token. Emitted tokens always come
from the verify oracle, so drafts change only how many tokens a step
yields.

Correctness oracle: the greedy tokens served for a request equal the
port's one-shot ``generate()`` on the same backend. Prefill pads the
prompt but selects the logits at its true last position; keys past a
lane's position are masked to exact-zero probability; lanes are
computed independently; the kernels and their plain versions give a
query's bits independent of how many queries or lanes ride with it; a
prefix-cache hit seeds bits an identical computation produced.

Disaggregated prefill/decode (the fleet's KV handoff): ``submit_handoff``
prefills a request that retires at its first token and exports the
lane's pages as stored; a decode engine claims a slot
(``handoff_claim``), installs the bytes (``handoff_install``) and
resumes the request (``resume_handoff``). Pool mutations that arrive on
replica connection threads run on the serving loop (``_run_on_loop``).

With an enabled ``telemetry`` block the engine serves its endpoint
(``telemetry_server``: the serving, kv_pool, prefix_cache, memtier and
kernels snapshots and a ``serving_loop`` health provider), evaluates the
SLO engine at the end of every step from host values only, and writes
``trace_file`` on ``close()``.

Tensor-parallel mesh (``serving.mesh_shape`` or a ``parallel`` block):
one process a rank, SPMD. Every rank builds the same engine from the
same whole model; the engine puts Megatron layers in place of each
block's qkv/ff1 (columns) and attn_out/ff2 (rows) under the serving
registry's rules (``partition_rules`` may restate them, never move
them), keeps the embeddings and the LM head replicated, and holds
``n_heads / model`` heads of every KV page. The decode and band kernels
run over a rank's heads; the row-parallel products are all-reduced over
the model group. The lanes are the same on every rank, which is kept so
by rank 0 of the mesh deciding each step: at the top of ``step()`` it
broadcasts a plan (the requests submitted since the last step, the
step's clock for every deadline decision, the degrade rung) and every
rank applies it; the tokens a step chooses (prefill's first tokens, the
decode and speculative steps' tokens) are rank 0's, broadcast. Requests
are submitted on rank 0, whose futures and streams resolve; the other
ranks run ``follow()`` until rank 0's ``close()``.

A monitor (``monitor=``, or the ds_config's monitors through
``from_config``) gets the JAX engine's ``Serving/*`` records; on a mesh
only rank 0 records. ``close()`` flushes it.

Sentinels (``sentinel_config``, the ``jax_sentinels`` block through
``from_config``): one ``CompileSentinel`` per program class, as the JAX
engine arms them (decode, window decode, kernel decode; batched prefill
per backend), each over a hot function that records its programs
(``profiling/sentinels.py: records_programs``), checked after every
decode step and every prefill. With ``transfer_guard`` the steady-state
decode (the class steps and the step's host read) runs inside
``transfer_free()``; the step's reads go through ``device_get``.

Left out (ROADMAP.md): on a mesh, the KV handoff, fault injection, the
memory-pressure guard and int8 weights.
"""

import contextlib
import dataclasses
import os
import queue as _queue_mod
import threading
import time
import weakref

import numpy as np
import torch

from deepspeed_tpu_torch import comm, kernels, telemetry
from deepspeed_tpu_torch.inference.generation import (
    ATTENTION_IMPLS,
    DEFAULT_PAGE_TOKENS,
    SPARSE_BAND,
    _cache_dtype,
    _chunk_attend_window,
    _chunk_layer,
    _chunk_rows,
    _decode_one,
    _dense_chunk_attend,
    _embed,
    _forward_chunk,
    _logits,
    _ngram_draft,
    _qkv_heads,
    _round_up,
    _window_finish,
    check_impl,
    check_tpu_knob,
    model_device,
    resolve_page_tokens,
)
from deepspeed_tpu_torch.inference.quantization import (
    dequantize_kv,
    is_quantized,
    quantize_kv,
    requantize_kv,
    vocab_size,
)
from deepspeed_tpu_torch.inference.serving.config import ServingConfig
from deepspeed_tpu_torch.profiling.sentinels import (
    CompileSentinel,
    device_get,
    records_programs,
    register_allowed_transfer,
    transfer_free,
)
from deepspeed_tpu_torch.inference.serving.degrade import DegradeLadder
from deepspeed_tpu_torch.inference.serving.fault_injection import ServingFaultInjector
from deepspeed_tpu_torch.inference.serving.kv_pool import (
    KV_CACHE_DTYPES,
    KVCachePool,
    PoolExhaustedError,
)
from deepspeed_tpu_torch.inference.serving.metrics import ServingMetrics
from deepspeed_tpu_torch.inference.serving.prefix_cache import (
    MemoryPressureGuard,
    PrefixKVCache,
    read_host_rss_mb,
)
from deepspeed_tpu_torch.inference.serving.scheduler import (
    ContinuousBatchingScheduler,
    EngineDrainingError,
    QueueFullError,
    Request,
    RequestTimeoutError,
    bucket_for,
    default_buckets,
)
from deepspeed_tpu_torch.kernels import sparse_attention as _sa
from deepspeed_tpu_torch.models.gpt2 import resolve_device
from deepspeed_tpu_torch.parallel import tp as _tp
from deepspeed_tpu_torch.parallel.mesh import mp_world_size
from deepspeed_tpu_torch.parallel.sharding_registry import (
    SERVING_TP_RULES,
    check_serving_placement,
    create_serving_mesh,
    serving_registry,
)


# the serving loop's host reads: a decode step's tokens (or oracle tokens
# and accepted counts) and a prefill's first tokens
_STEP_READ = register_allowed_transfer("serving/step_read")
_FIRST_TOKEN_READ = register_allowed_transfer("serving/first_token_read")


def _submitted_at(age_s):
    """The enqueue time of a request ``age_s`` seconds old (None: now)."""
    return time.monotonic() - float(age_s) if age_s and age_s > 0 else None


# the decode program each backend's lanes run
LANE_CLASS = {"dense": "dense", "flash": "dense", "sparse_xla": "sparse_xla",
              "pallas_decode": "pallas_decode", "pallas_sparse": "pallas_sparse"}
_WINDOW_IMPLS = ("sparse_xla", "pallas_sparse")


def _parse_attention_impl(spec, buckets):
    """Validate ``serving.attention_impl``: None / a backend name (every
    bucket) / a ``{bucket: impl}`` dict with an optional ``"default"``
    key. Returns ``(default_impl, {bucket: impl})``."""
    if spec is None:
        return "dense", {}
    if isinstance(spec, str):
        check_impl(spec)
        return spec, {}
    if not isinstance(spec, dict):
        raise ValueError(
            f"serving.attention_impl must be one of {ATTENTION_IMPLS} or a "
            f"{{bucket: impl}} dict, got {spec!r}")
    default = "dense"
    table = {}
    for key, impl in spec.items():
        check_impl(impl)
        if key == "default":
            default = impl
            continue
        if isinstance(key, bool) or not isinstance(key, int):
            raise ValueError(
                f"serving.attention_impl keys must be prompt-bucket ints or "
                f"'default', got {key!r}")
        if key not in tuple(buckets):
            raise ValueError(
                f"serving.attention_impl bucket {key} is not in the prompt "
                f"bucket ladder {tuple(buckets)}")
        table[int(key)] = impl
    return default, table


# -- paged-pool plumbing -----------------------------------------------------

def _row_pages(page_tables, tok, active, page_tokens):
    """Physical page for per-lane token indices ``tok`` ([B] or [B, n]):
    the lane's mapped page, or the null page 0 for inactive lanes and
    out-of-range indices. torch has no dropping scatter, so bad writes are
    routed to the null page explicitly, never clipped onto a live row."""
    B, mp = page_tables.shape
    tok2 = tok if tok.dim() == 2 else tok[:, None]
    logical = torch.clamp(torch.div(tok2, page_tokens, rounding_mode="floor"),
                          0, mp - 1)
    phys = page_tables.gather(1, logical)
    ok = active[:, None] & (tok2 >= 0) & (tok2 < mp * page_tokens)
    phys = torch.where(ok, phys, torch.zeros_like(phys))
    return phys if tok.dim() == 2 else phys[:, 0]


def _stored(rows, qmode, scale_l):
    """A layer's fresh rows ([B, nh, hd] or [B, n, nh, hd]) in the pool's
    storage form."""
    if qmode == "int8" and rows.dim() == 4:
        return requantize_kv(rows.transpose(1, 2), scale_l).transpose(1, 2)
    if qmode == "int8":
        return requantize_kv(rows[:, :, None, :], scale_l)[:, :, 0]
    if qmode == "bf16":
        return rows.to(torch.bfloat16)
    return rows


def _compute(x, qmode, scale, dtype):
    """Pool storage -> compute dtype (``scale`` broadcast per lane/head)."""
    if qmode == "int8":
        return dequantize_kv(x, scale, dtype)
    if qmode == "bf16":
        return x.to(dtype)
    return x


def _finish_step(model, h, tokens, positions, active):
    nxt = torch.argmax(_logits(model, h), dim=-1)
    return (torch.where(active, nxt, tokens),
            torch.where(active, positions + 1, positions))


@records_programs
def _decode_step_dense(model, pool, page_tables, tokens, positions, active,
                       n_heads, qmode, dtype):
    """Dense decode: per layer, gather each lane's pages into its
    contiguous stripe (compute dtype), run the one-shot path's
    `_decode_one` against it, and store the freshly written row back
    into its page (requantized against the lane's fixed scale in int8
    mode)."""
    pt = pool.page_tokens
    B, mp = page_tables.shape
    lanes = torch.arange(B, device=tokens.device)
    h = _embed(model, tokens, positions)
    dp = _row_pages(page_tables, positions, active, pt)
    off = positions % pt
    row = torch.clamp(positions, 0, mp * pt - 1)
    for l, layer in enumerate(model.layers):
        sk = pool.k_scale[l] if qmode == "int8" else None
        sv = pool.v_scale[l] if qmode == "int8" else None

        def stripe(side, scale):
            g = side[l][page_tables].transpose(1, 2)         # [B, nh, mp, pt, hd]
            g = g.reshape(B, n_heads, mp * pt, -1)
            return _compute(g, qmode, scale, dtype)

        ck, cv = stripe(pool.k, sk), stripe(pool.v, sv)
        h = _decode_one(layer, h, ck, cv, row, n_heads)
        pool.k[l][dp, :, off] = _stored(ck[lanes, :, row], qmode, sk)
        pool.v[l][dp, :, off] = _stored(cv[lanes, :, row], qmode, sv)
    return _finish_step(model, h, tokens, positions, active)


def _page_scales(scale_l, page_tables, n_pages):
    """Per-(slot, head) install scales -> per-physical-page scales [P, nh]
    for the kernel. Lanes never share data pages; the null page takes
    whichever lane's write lands last (the winner of duplicate indices is
    undefined on CUDA), which is harmless: only masked keys ever read
    it."""
    B, mp = page_tables.shape
    nh = scale_l.shape[1]
    s = scale_l.reshape(B, 1, nh).expand(B, mp, nh)
    out = torch.zeros((n_pages, nh), dtype=torch.float32, device=scale_l.device)
    out[page_tables.long()] = s
    return out


@records_programs
def _decode_step_kernel(model, pool, page_tables, tokens, positions, active,
                        n_heads, qmode, dtype):
    """``pallas_decode`` lanes: per layer write the fresh row into its
    page, then run the paged decode-attention kernel on the pool itself
    (storage dtype) through the lane page tables; int8 pools pass the
    lanes' scales spread to their pages."""
    pt = pool.page_tokens
    h = _embed(model, tokens, positions)
    dp = _row_pages(page_tables, positions, active, pt)
    off = positions % pt
    qpos = positions[:, None]
    P = pool.k.shape[1]
    for l, layer in enumerate(model.layers):
        q, kk, vv = _qkv_heads(layer, h, n_heads)
        sk = pool.k_scale[l] if qmode == "int8" else None
        sv = pool.v_scale[l] if qmode == "int8" else None
        pk_l, pv_l = pool.k[l], pool.v[l]
        pk_l[dp, :, off] = _stored(kk, qmode, sk)
        pv_l[dp, :, off] = _stored(vv, qmode, sv)
        ksp = _page_scales(sk, page_tables, P) if sk is not None else None
        vsp = _page_scales(sv, page_tables, P) if sv is not None else None
        ctx = kernels.decode_attend(q[:, None], pk_l, pv_l, page_tables, qpos,
                                    page_tokens=pt, dtype=dtype,
                                    k_scale=ksp, v_scale=vsp)[:, 0]
        h = _window_finish(layer, h, ctx)
    return _finish_step(model, h, tokens, positions, active)


@records_programs
def _decode_step_window(model, pool, page_tables, tokens, positions, active,
                        n_heads, qmode, dtype, kernel=True):
    """``pallas_sparse`` lanes: per layer write the fresh row into its
    page, gather each lane's window pages (SPARSE_BAND+1 pages ending at
    its own) and anchor page, and run the band kernel — O(page_tokens)
    KV per token instead of O(max_seq_len). ``kernel=False`` (the
    ``sparse_xla`` lanes) runs the band's plain version in composed ops."""
    pt = pool.page_tokens
    B, mp = page_tables.shape
    h = _embed(model, tokens, positions)
    pp = torch.clamp(torch.div(positions, pt, rounding_mode="floor"), 0, mp - 1)
    lo = torch.clamp_min(pp - SPARSE_BAND, 0)
    base = lo * pt
    win_logical = torch.clamp(
        lo[:, None] + torch.arange(SPARSE_BAND + 1, device=lo.device), 0, mp - 1)
    win_phys = page_tables.gather(1, win_logical)
    sink_phys = page_tables[:, 0]
    dp = _row_pages(page_tables, positions, active, pt)
    off = positions % pt
    for l, layer in enumerate(model.layers):
        q, kk, vv = _qkv_heads(layer, h, n_heads)
        sk = pool.k_scale[l] if qmode == "int8" else None
        sv = pool.v_scale[l] if qmode == "int8" else None
        pk_l, pv_l = pool.k[l], pool.v[l]
        pk_l[dp, :, off] = _stored(kk, qmode, sk)
        pv_l[dp, :, off] = _stored(vv, qmode, sv)

        def window(side, scale):
            win = side[win_phys].transpose(1, 2)             # [B, nh, bw, pt, hd]
            win = win.reshape(B, n_heads, (SPARSE_BAND + 1) * pt, -1)
            return (_compute(win, qmode, scale, dtype).contiguous(),
                    _compute(side[sink_phys], qmode, scale, dtype).contiguous())

        k_win, k_sink = window(pk_l, sk)
        v_win, v_sink = window(pv_l, sv)
        band = kernels.band_attend if kernel else _plain_band
        ctx = band(q, k_win, v_win, k_sink, v_sink, positions, base, dtype=dtype)
        h = _window_finish(layer, h, ctx)
    return _finish_step(model, h, tokens, positions, active)


def _plain_band(q, k_win, v_win, k_sink, v_sink, pos, base, *, dtype):
    return _sa._band_attend_torch(q.contiguous(), k_win, v_win, k_sink, v_sink,
                                  pos.to(torch.int32), base.to(torch.int32), dtype)


_DECODE_STEPS = {"dense": _decode_step_dense,
                 "sparse_xla": lambda *a: _decode_step_window(*a, kernel=False),
                 "pallas_decode": _decode_step_kernel,
                 "pallas_sparse": _decode_step_window}


def _lane_stripe(side_l, page_tables, qmode, scale_l, dtype):
    """One layer's lane stripes [B, nh, mp*pt, hd] in the compute dtype,
    gathered from the pool's pages."""
    B, mp = page_tables.shape
    _, nh, pt, hd = side_l.shape
    g = side_l[page_tables].transpose(1, 2).reshape(B, nh, mp * pt, hd)
    return _compute(g, qmode, scale_l, dtype)


def _rows_at(stripe, tok):
    """Rows of stripes [B, nh, S, hd] at per-lane indices ``tok`` [B, n]
    -> [B, n, nh, hd] (reads clip; the matching writes go to the null page)."""
    B, S = stripe.shape[0], stripe.shape[2]
    lanes = torch.arange(B, device=stripe.device)[:, None]
    return stripe.transpose(1, 2)[lanes, tok.clamp(0, S - 1)]


@records_programs(split="lane_class", traced=("positions_host",))
def _spec_step(model, pool, page_tables, history, tokens, positions, positions_host,
               active, noise, k, n_heads, qmode, dtype, lane_class):
    """One speculative step for one lane class: draft ``k`` tokens a lane
    (n-gram lookup over ``history`` [B, S + k + 1]), verify the k+1
    positions in one forward, append the oracle to the history, advance
    each active lane by accepted + 1. Per layer the k+1 fresh rows go
    into their pages first and the attention reads them from there (the
    class's decode step does the same), except for dense lanes, which
    attend over their gathered stripe and store the rows after. Returns
    (tokens, positions, oracle [B, k+1], accepted [B])."""
    pt = pool.page_tokens
    B, mp = page_tables.shape
    S = mp * pt
    dev = tokens.device
    C = k + 1
    drafts = _ngram_draft(history[:, :S], positions, k)
    drafts = (drafts + noise) % vocab_size(model.wte)
    ids = torch.cat([tokens[:, None], drafts], dim=1)                 # [B, C]
    qpos = positions[:, None] + torch.arange(C, device=dev)[None, :]
    h = _embed(model, ids, qpos)
    dp = _row_pages(page_tables, qpos, active, pt)
    off = qpos % pt
    rows = _chunk_rows(positions_host, C, S, dev) if lane_class == "dense" else None
    P = pool.k.shape[1]
    for l, layer in enumerate(model.layers):
        sk = pool.k_scale[l] if qmode == "int8" else None
        sv = pool.v_scale[l] if qmode == "int8" else None
        pk_l, pv_l = pool.k[l], pool.v[l]
        if lane_class == "dense":
            ck = _lane_stripe(pk_l, page_tables, qmode, sk, dtype)
            cv = _lane_stripe(pv_l, page_tables, qmode, sv, dtype)
            h = _chunk_layer(layer, h, ck, cv, rows, qpos, n_heads, _dense_chunk_attend)
            pk_l[dp, :, off] = _stored(_rows_at(ck, qpos), qmode, sk)
            pv_l[dp, :, off] = _stored(_rows_at(cv, qpos), qmode, sv)
            continue
        q, kk, vv = _qkv_heads(layer, h, n_heads)
        pk_l[dp, :, off] = _stored(kk, qmode, sk)
        pv_l[dp, :, off] = _stored(vv, qmode, sv)
        if lane_class == "pallas_decode":
            ksp = _page_scales(sk, page_tables, P) if sk is not None else None
            vsp = _page_scales(sv, page_tables, P) if sv is not None else None
            ctx = kernels.decode_attend(q, pk_l, pv_l, page_tables, qpos, page_tokens=pt,
                                        dtype=dtype, k_scale=ksp, v_scale=vsp,
                                        prefill=False)
        else:
            ck = _lane_stripe(pk_l, page_tables, qmode, sk, dtype)
            cv = _lane_stripe(pv_l, page_tables, qmode, sv, dtype)
            if lane_class == "pallas_sparse":
                ctx = kernels.chunk_band_attend(q, ck, cv, qpos, pt, dtype)
            else:
                ctx = _chunk_attend_window(q, ck, cv, qpos, pt, dtype)
        h = _window_finish(layer, h, ctx)
    oracle = torch.argmax(_logits(model, h), dim=-1)                  # [B, C]
    ok = (drafts == oracle[:, :k]).long()
    accepted = torch.cumprod(ok, dim=1).sum(dim=1)
    # the k+1 oracle tokens go into the history at the lane's write window;
    # those past the accepted point are overwritten by the next step
    idx = positions[:, None] + 1 + torch.arange(C, device=dev)[None, :]
    history.scatter_(1, idx, torch.where(active[:, None], oracle, history.gather(1, idx)))
    last = oracle.gather(1, accepted[:, None])[:, 0]
    tokens = torch.where(active, last, tokens)
    positions = torch.where(active, torch.clamp(positions + accepted + 1, max=S - 1),
                            positions)
    return tokens, positions, oracle, accepted


@records_programs(split="attn_impl", traced=("starts", "true_lens"))
def _prefill_batch(model, init_k, init_v, padded_ids, starts, true_lens,
                   n_heads, attn_impl, page_tokens):
    """Batched prefill: ``padded_ids`` [B, Sb] forwarded in one causal
    call into ``init_k``/``init_v`` ([L, B, nh, S_max, hd], in place) at
    per-lane offsets ``starts`` (host ints: 0, a prefix-cache hit's length
    or a chunk's offset); returns each lane's first greedy token, selected
    at its true last prompt position (pad tokens and dummy lanes are
    invisible to it)."""
    B, Sb = padded_ids.shape
    h = _forward_chunk(model, n_heads, (init_k, init_v), padded_ids, starts,
                       attn_impl=attn_impl, page_tokens=page_tokens)
    idx = np.clip(np.asarray(true_lens) - 1 - np.asarray(starts), 0, Sb - 1)
    idx = torch.as_tensor(idx, dtype=torch.long, device=h.device)
    h_sel = h[torch.arange(B, device=h.device), idx]
    return torch.argmax(_logits(model, h_sel), dim=-1)


class _ChunkedPrefill:
    """In-flight chunked prefill: the request, its private cache pair
    (carried across engine steps between chunk calls), how far it has
    prefilled, the prefix reuse it started from, and the pool slot
    reserved for it at start."""

    __slots__ = ("req", "k", "v", "pos", "reuse", "slot", "prefill_s", "first")

    def __init__(self, req, k, v, pos, reuse, slot):
        self.req = req
        self.k = k
        self.v = v
        self.pos = pos
        self.reuse = reuse
        self.slot = slot
        self.prefill_s = 0.0
        self.first = None


class _EngineLadderShim:
    """Ladder facade for the MemoryPressureGuard: the engine creates its
    DegradeLadder lazily, so the guard reads and writes through the
    engine."""

    __slots__ = ("_engine",)

    def __init__(self, engine):
        self._engine = engine

    @property
    def rung(self):
        return self._engine._degrade_rung

    def set_rung(self, rung, reason="forced"):
        return self._engine.set_degrade_rung(rung, reason=reason)


class ServingEngine:
    """Request queue + paged KV pool + the batched decode loop.

    Drive it synchronously (``step()`` / ``drain()``) or on a background
    thread (``start()`` / ``stop()``) with ``submit()`` from any thread.
    ``model`` is a ``GPT2LMHeadModel`` already on ``device`` (int8 weights
    from ``quantize_for_decode`` included); ``device`` defaults to CUDA and
    raises without a card."""

    def __init__(self, model, model_config, serving_config=None,
                 device="cuda", injector=None, telemetry_config=None, rank=None,
                 monitor=None, sentinel_config=None):
        cfg = serving_config or ServingConfig()
        self.device = resolve_device(device)
        if model_device(model) != self.device:
            raise ValueError(f"model is on {model_device(model)}, not {self.device}")
        self.model = model
        self.model_config = model_config
        self.config = cfg
        self.n_layers = model_config.num_hidden_layers
        self.n_heads = model_config.num_attention_heads
        self.head_dim = model_config.hidden_size // self.n_heads

        check_tpu_knob("serving.attention_kernel", cfg.attention_kernel)
        check_tpu_knob("serving.kernel_interpret", cfg.kernel_interpret)

        mpe = model_config.max_position_embeddings
        self.max_seq_len = cfg.max_seq_len or mpe
        if self.max_seq_len > mpe:
            raise ValueError(
                f"serving.max_seq_len={self.max_seq_len} exceeds "
                f"max_position_embeddings={mpe}")
        buckets = cfg.prompt_buckets or default_buckets(self.max_seq_len - 1)
        if buckets[-1] > self.max_seq_len - 1:
            raise ValueError(
                f"largest prompt bucket ({buckets[-1]}) must leave room for "
                f"one generated token (max_seq_len={self.max_seq_len})")
        self._check_knobs(cfg)
        self._impl_default, self._impl_map = _parse_attention_impl(
            cfg.attention_impl, buckets)
        impls = set(self._impl_map.values()) | {self._impl_default}
        page_tokens = resolve_page_tokens(
            cfg.kv_page_tokens or DEFAULT_PAGE_TOKENS, self.max_seq_len)
        if (impls & set(_WINDOW_IMPLS)
                and self.max_seq_len < (SPARSE_BAND + 1) * page_tokens):
            raise ValueError(
                f"serving.attention_impl='sparse_xla'/'pallas_sparse' needs at "
                f"least {SPARSE_BAND + 1} pages per lane: max_seq_len="
                f"{self.max_seq_len} < {(SPARSE_BAND + 1) * page_tokens} "
                f"(kv_page_tokens={page_tokens})")

        # the tensor-parallel mesh: None keeps the single-device engine
        self.mesh = None
        self.registry = None
        self._lockstep = False      # more than one rank: steps follow plans
        self._lead = True           # this rank plans each step
        self._plan = None
        self._inbox = []            # rank 0's requests since the last plan
        self._inbox_lock = threading.Lock()
        self._stopped = False
        if cfg.mesh_shape is not None:
            self._arm_mesh(model, cfg, injector)
        self.local_heads = self.n_heads // (mp_world_size(self.mesh) if self.mesh else 1)

        dtype = _cache_dtype(model)
        self.pool = KVCachePool(self.n_layers, cfg.max_slots, self.n_heads,
                                self.max_seq_len, self.head_dim, dtype=dtype,
                                kv_cache_dtype=cfg.kv_cache_dtype,
                                page_tokens=cfg.kv_page_tokens,
                                pool_tokens=cfg.kv_pool_tokens,
                                device=self.device,
                                model_parallel=self.n_heads // self.local_heads)
        # storage <-> compute conversion the decode steps need: None when
        # the pool stores the compute dtype (fp32, or bf16 on a bf16 model)
        if cfg.kv_cache_dtype == "int8":
            self._qmode = "int8"
        elif self.pool.k.dtype != dtype:
            self._qmode = "bf16"
        else:
            self._qmode = None
        self._spec_k = int(cfg.speculative_k)
        self._arm_sentinels(sentinel_config, impls)
        # degraded-mode ladder: armed by configure_degrade() or lazily by
        # set_degrade_rung(); _degrade_rung is the hot-path mirror
        self._degrade = None
        self._degrade_rung = 0
        self.scheduler = ContinuousBatchingScheduler(
            max_queue=cfg.max_queue, buckets=buckets,
            default_max_new_tokens=cfg.default_max_new_tokens,
            request_timeout_s=cfg.request_timeout_s)
        # on a mesh rank 0 records: the others hold no request a client sees
        self.metrics = ServingMetrics(monitor if self._lead else None)
        self.metrics.record_kv_pool_bytes(self.pool.nbytes())
        if injector is None and cfg.fault_injection:
            injector = ServingFaultInjector(cfg.fault_injection)
        self.injector = injector
        spill_dir = cfg.prefix_spill_dir
        if spill_dir is not None and self._lockstep:
            # a rank's blobs hold its heads: one directory a rank
            spill_dir = os.path.join(spill_dir, f"rank{comm.group_rank(self._plan_group)}")
        self.prefix_cache = (
            PrefixKVCache(max(1, int(cfg.prefix_cache_mb * 2 ** 20)),
                          spill_budget_bytes=int(cfg.prefix_spill_mb * 2 ** 20),
                          spill_dir=spill_dir,
                          listener=self._on_spill_event)
            if cfg.prefix_cache_mb > 0 else None)
        if self.prefix_cache is not None and self.prefix_cache.spill is not None:
            if self.injector is not None:
                self.prefix_cache.spill.torn_write_hook = self.injector.torn_spill_write
            self.metrics.set_spill_sources(spill_stats_fn=self.prefix_cache.spill.stats,
                                           host_rss_mb_fn=read_host_rss_mb)
        elif cfg.host_mem_watermark_mb > 0:
            self.metrics.set_spill_sources(host_rss_mb_fn=read_host_rss_mb)
        # host-memory watchdog: one check a step; sheds the spill tier,
        # pauses prefix inserts, then climbs the degrade ladder
        self._mem_guard = (
            MemoryPressureGuard(cfg.host_mem_watermark_mb, cache=self.prefix_cache,
                                ladder=_EngineLadderShim(self),
                                read_rss_mb=self._guard_rss_mb,
                                listener=self._on_mem_pressure_level)
            if cfg.host_mem_watermark_mb > 0 else None)
        self._pool_relief_attempts = 0

        self._active = {}                                   # slot -> Request
        self._lane_tokens = np.zeros(cfg.max_slots, np.int64)
        self._lane_active = np.zeros(cfg.max_slots, bool)
        self._lane_impl = np.array(["dense"] * cfg.max_slots, dtype=object)
        # device copies of the lane state: uploaded only on lane churn,
        # advanced on the device between churns
        self._dev_tokens = None
        self._dev_positions = None
        self._dev_active = {}                               # lane class -> mask
        self._dev_page_tables = None
        self._lane_dirty = True
        # speculation: each lane's tokens by position, feeding the drafter
        # (host mirror for churn uploads; k+1 spare columns take the
        # oracle's writes past the end), and the corrupt_draft noise
        self._lane_history = (
            np.zeros((cfg.max_slots, self.max_seq_len + self._spec_k + 1), np.int64)
            if self._spec_k > 0 else None)
        self._dev_history = None
        self._dev_noise = None
        self._noise_armed = False
        # the prefill KV buffer: [L, max_slots, nh, max_seq_len, hd] in the
        # compute dtype, allocated at the first admission and reused
        self._prefill_kv = None
        self._prefill_batch = cfg.max_slots
        self._chunking = None               # at most one chunked prefill
        self._step_count = 0
        self._busy_steps = 0
        self._loop_thread = None
        self._stop = threading.Event()
        self._draining = False              # planned restart: admit nothing
        # the pool has no lock: every mutation happens on the serving-loop
        # thread. Handoff pool ops (claim/install/free/resume) arrive on
        # replica connection threads and are posted here, drained at the
        # top of step()
        self._loop_ops = _queue_mod.Queue()

        # an explicit block arms the process-global tracer and registry; an
        # absent block leaves them untouched
        telemetry.configure_from_config(telemetry_config, rank=rank, role="serve")
        self._tracer = telemetry.get_tracer()
        self._trace_file = None
        self.telemetry_server = None
        self.slo = None
        # on a mesh rank 0 serves the endpoint and judges the SLOs: the
        # others hold no request a client sees
        if telemetry_config is not None and telemetry_config.enabled and self._lead:
            reg = telemetry.get_registry()
            self._trace_file = telemetry_config.trace_file
            self.metrics.export_to(reg)
            if self.prefix_cache is not None and self.prefix_cache.spill is not None:
                reg.gauge_fn("Serving/SpillTier", self.prefix_cache.spill.stats,
                             help="host-RAM/disk spill tier occupancy")
            if self._mem_guard is not None or cfg.host_mem_watermark_mb > 0:
                reg.gauge_fn("Serving/HostRssMb", read_host_rss_mb,
                             help="process resident set size (MiB)")
            if any(kernels.kernel_for_backend(i) for i in impls):
                # per-kernel launch gauges at /metrics
                kernels.export_gauges(reg)
            # an explicit http_port wins; a supervised worker with a null
            # port inherits DSTPU_TELEMETRY_PORT
            http_port = telemetry.resolve_http_port(telemetry_config)
            if http_port is not None:
                self.telemetry_server = self._build_telemetry_server(http_port)
            self.slo = telemetry.SloEngine.from_config(
                telemetry_config, tracer=self._tracer, registry=reg)
            if self.slo is not None and self.telemetry_server is not None:
                self.slo.attach(self.telemetry_server)

    # -- sentinels -------------------------------------------------------
    def _arm_sentinels(self, sentinel_config, impls):
        """One CompileSentinel per program class the configured backends
        run, as the JAX engine arms them: a decode class under
        speculation is its lane class's programs of ``_spec_step``; a
        prefill class, its backend's programs of ``_prefill_batch``."""
        self.decode_sentinel = self.decode_window_sentinel = None
        self.decode_kernel_sentinel = None
        self.prefill_sentinels = {}
        self._transfer_guard = False
        if sentinel_config is None or not sentinel_config.enabled:
            return
        budget = sentinel_config.compile_budget
        spec = self._spec_k > 0
        window, kfull, kwin = ("sparse_xla" in impls, "pallas_decode" in impls,
                               "pallas_sparse" in impls)

        def sentinel(fn, name):
            return CompileSentinel(fn, budget, name=name)

        self.decode_sentinel = sentinel(
            _spec_step.view("dense") if spec else _decode_step_dense, "serving decode step")
        if window or (kwin and not spec):
            self.decode_window_sentinel = sentinel(
                _spec_step.view("sparse_xla") if spec else _decode_step_window,
                "serving window decode step")
        if kfull or (kwin and spec):
            self.decode_kernel_sentinel = sentinel(
                _spec_step.view("pallas_decode", "pallas_sparse") if spec
                else _decode_step_kernel, "serving kernel decode step")
        names = {"dense": "serving batched prefill", "sparse_xla": "serving window prefill",
                 "flash": "serving flash prefill", "pallas_decode": "serving kernel prefill",
                 "pallas_sparse": "serving kernel window prefill"}
        for impl in {"dense"} | set(impls):
            self.prefill_sentinels[impl] = sentinel(_prefill_batch.view(impl), names[impl])
        self._transfer_guard = bool(sentinel_config.transfer_guard)

    def _guard(self):
        return transfer_free() if self._transfer_guard else contextlib.nullcontext()

    def _check_decode_sentinels(self):
        """The budget checks of every armed decode class (the classes
        share the step, so they share the check)."""
        for s in (self.decode_sentinel, self.decode_window_sentinel,
                  self.decode_kernel_sentinel):
            if s is not None:
                s.check()

    def _run_prefill(self, model, init_k, init_v, ids, starts, lens, impl):
        """The batched prefill of one backend, then its sentinel's check."""
        first = _prefill_batch(model, init_k, init_v, ids, starts, lens, self.local_heads,
                               impl, self.pool.page_tokens)
        sentinel = self.prefill_sentinels.get(impl)
        if sentinel is not None:
            sentinel.check()
        return first

    # -- tensor-parallel mesh -------------------------------------------
    def _arm_mesh(self, model, cfg, injector):
        """Build the serving mesh over the running ranks, hold the rules to
        the placements the port runs, and put Megatron layers in place of
        the blocks' projections (embeddings and LM head replicated)."""
        self.registry = serving_registry(extra_rules=cfg.partition_rules,
                                         replicate_unmatched=cfg.replicate_unmatched)
        self.mesh = create_serving_mesh(cfg.mesh_shape)
        self.registry.validate_axes(self.mesh)
        mp = mp_world_size(self.mesh)
        if self.n_heads % mp != 0:
            raise ValueError(
                f"serving.mesh_shape model axis {mp} must divide "
                f"num_attention_heads={self.n_heads} (the KV pool "
                f"shards heads)")
        check_serving_placement(self.registry, model)
        refused = [what for what, on in (
            ("serving.fault_injection", injector is not None or cfg.fault_injection),
            ("serving.host_mem_watermark_mb", cfg.host_mem_watermark_mb > 0),
            ("int8 weights (quantize_for_decode)",
             is_quantized(model.wte) or any(is_quantized(getattr(layer, n))
                                            for layer in model.layers
                                            for n in ("qkv", "attn_out", "ff1", "ff2"))),
        ) if on]
        if refused and mp > 1:
            raise NotImplementedError(
                f"{', '.join(refused)} on a serving mesh: not ported to "
                "deepspeed_tpu_torch yet (ROADMAP.md, queue 1)")
        _tp.shard_params(model, self.mesh, rules=SERVING_TP_RULES)
        self._plan_group = comm.control_group() if torch.distributed.is_initialized() else None
        self._lockstep = comm.group_size(self._plan_group) > 1
        self._lead = comm.group_rank(self._plan_group) == 0

    def _exchange_plan(self, now, stop=False):
        """Rank 0 plans the step and every rank takes its plan: the requests
        submitted since the last plan (rank 0's own objects, rebuilt from
        their fields elsewhere), the clock every deadline decision of the
        step reads, and the degrade rung. Returns the plan."""
        plan = new = None
        if self._lead:
            with self._inbox_lock:
                new, self._inbox = self._inbox, []
            plan = {"now": now, "stop": bool(stop), "rung": self._degrade_rung,
                    "new": [(r.id, r.prompt, r.max_new_tokens, r.eos_token_id,
                             r.timeout_s, r.submit_time) for r in new]}
        plan = comm.broadcast_object(plan, self._plan_group)
        if not self._lead:
            new = [Request(rid, prompt, n_new, eos_token_id=eos, timeout_s=timeout,
                           submitted_at=t0)
                   for rid, prompt, n_new, eos, timeout, t0 in plan["new"]]
            self._degrade_rung = plan["rung"]
        for req in new:
            self.scheduler.enqueue(req)
        self._plan = plan
        return plan

    def _decision_now(self, now):
        """The clock a deadline decision reads: the plan's on a mesh, so every
        rank retires the same requests at the same step."""
        return self._plan["now"] if self._lockstep else now

    def _rung(self):
        """The degrade rung this step runs at (the plan's on a mesh)."""
        return self._plan["rung"] if self._lockstep else self._degrade_rung

    def _from_lead(self, t):
        """Rank 0's copy of a tensor of chosen tokens (``t`` itself off a
        mesh): reduction order may not fork the ranks."""
        if not self._lockstep:
            return t
        return comm.broadcast(t, self._plan_group, root=0)

    def follow(self):
        """A follower rank's serving loop: step on rank 0's plans until rank
        0 closes its engine. Returns the steps taken."""
        if not self._lockstep or self._lead:
            raise RuntimeError("follow() runs on the ranks other than 0 of a serving mesh")
        steps = 0
        while self.step() is not None:
            steps += 1
        self._stopped = True
        return steps

    def _build_telemetry_server(self, port):
        srv = telemetry.TelemetryServer(registry=telemetry.get_registry(),
                                        tracer=self._tracer, port=port)
        srv.add_snapshot_provider("serving", self.metrics.snapshot)
        srv.add_snapshot_provider("kv_pool", self.occupancy)
        srv.add_snapshot_provider("prefix_cache", self.prefix_stats)
        srv.add_snapshot_provider("memtier", self.memtier_stats)
        srv.add_snapshot_provider("kernels", kernels.registry_snapshot)
        srv.add_health_provider("serving_loop", self._loop_health)
        return srv.start()

    def _loop_health(self):
        """Healthy unless a background loop was started and then died
        (synchronous step()/drain() driving is always healthy)."""
        t = self._loop_thread
        return {"healthy": t is None or t.is_alive(),
                "background_loop": t is not None,
                "steps": self._step_count,
                "active_requests": len(self._active),
                "queue_depth": self.scheduler.queue_depth(),
                "draining": self._draining,
                "degrade_rung": self._degrade_rung}

    def _slo_values(self):
        """SLO inputs, host values only: the pushed registry metrics plus
        the live serving snapshot under ``Serving/*`` (pull gauges are
        skipped: the snapshot is already here)."""
        vals = {k: v for k, v in telemetry.get_registry().as_dict(pulled=False).items()
                if isinstance(v, (int, float)) and not isinstance(v, bool)}
        for k, v in self.metrics.snapshot().items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                vals[f"Serving/{k}"] = v
        return vals

    def _check_knobs(self, cfg):
        """The JAX engine's checks of the slice's knobs."""
        if cfg.prefill_chunk_tokens < 0:
            raise ValueError(
                f"serving.prefill_chunk_tokens must be >= 0 (0 disables chunked "
                f"prefill), got {cfg.prefill_chunk_tokens}")
        for knob, what in (("prefix_cache_mb", "the prefix cache"),
                           ("prefix_spill_mb", "the spill tier"),
                           ("host_mem_watermark_mb", "the memory-pressure guard")):
            if getattr(cfg, knob) < 0:
                raise ValueError(f"serving.{knob} must be >= 0 (0 disables {what}), "
                                 f"got {getattr(cfg, knob)}")
        if cfg.prefix_spill_mb > 0 and cfg.prefix_cache_mb <= 0:
            raise ValueError(
                f"serving.prefix_spill_mb={cfg.prefix_spill_mb} needs a live prefix "
                f"cache (prefix_cache_mb > 0) to spill from")
        if cfg.prefix_spill_dir is not None and cfg.prefix_spill_mb <= 0:
            raise ValueError(
                f"serving.prefix_spill_dir={cfg.prefix_spill_dir!r} needs a spill "
                f"tier (prefix_spill_mb > 0) above it")
        k = cfg.speculative_k
        if isinstance(k, bool) or not isinstance(k, int) or k < 0:
            raise ValueError(f"serving.speculative_k must be an int >= 0 (0 disables "
                             f"speculative decoding), got {k!r}")
        if k >= self.max_seq_len:
            raise ValueError(f"serving.speculative_k={k} must be smaller than "
                             f"max_seq_len={self.max_seq_len}")
        if cfg.kv_cache_dtype not in KV_CACHE_DTYPES:
            raise ValueError(
                f"serving.kv_cache_dtype must be one of {KV_CACHE_DTYPES}, "
                f"got {cfg.kv_cache_dtype!r}")
        for knob in ("kv_page_tokens", "kv_pool_tokens"):
            val = getattr(cfg, knob)
            if val is not None and (isinstance(val, bool)
                                    or not isinstance(val, int) or val < 1):
                raise ValueError(f"serving.{knob} must be an int >= 1 or None, "
                                 f"got {val!r}")

    @classmethod
    def from_config(cls, model, model_config, ds_config, rank=0, injector=None,
                    device="cuda"):
        """Build from a ds_config (dict or ``DeepSpeedConfig``): its
        validated ``serving`` and ``telemetry`` blocks and its monitors
        (``monitor_from_config``); an enabled
        ``fleet.degrade`` sub-block arms the degraded-mode ladder, and a
        ``parallel`` block the tensor-parallel mesh."""
        from deepspeed_tpu_torch.monitor import monitor_from_config
        from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig

        if isinstance(ds_config, dict):
            ds_config = DeepSpeedConfig(ds_config, world_size=1)
        serving_cfg = ds_config.serving_config
        parallel = ds_config.parallel_config
        if parallel.enabled:
            # the validated `parallel` block arms the mesh, as in the JAX engine
            serving_cfg = dataclasses.replace(
                serving_cfg, mesh_shape=parallel.mesh_shape,
                partition_rules=parallel.partition_rules,
                replicate_unmatched=parallel.replicate_unmatched)
        eng = cls(model, model_config, serving_config=serving_cfg,
                  device=device, injector=injector,
                  telemetry_config=ds_config.telemetry_config, rank=rank,
                  monitor=monitor_from_config(ds_config, rank),
                  sentinel_config=ds_config.sentinel_config)
        fleet = ds_config.fleet_config
        if fleet.enabled and fleet.degrade.enabled:
            eng.configure_degrade(fleet.degrade)
        return eng

    # -- degraded-mode ladder -------------------------------------------
    def configure_degrade(self, degrade_config):
        """Arm the degraded-mode ladder (a ``DegradeConfig`` or a
        ``DegradeLadder``). Rung 1 turns speculation off (safe mid-flight:
        emitted tokens always come from the verify oracle); rung 2 also
        pauses prefix-cache inserts and halves the admission queue."""
        # the ladder's gauge lives in the process-global registry, so the
        # ladder reaches the engine only weakly: a bound method here kept a
        # dropped engine, its model and its pool on the card for good
        me = weakref.ref(self)

        def on_change(old, new, reason):
            eng = me()
            if eng is not None:
                eng._on_degrade_change(old, new, reason)

        if isinstance(degrade_config, DegradeLadder):
            self._degrade = degrade_config
            self._degrade._on_change = on_change
        else:
            self._degrade = DegradeLadder(degrade_config, on_change=on_change, name="engine")
        self._degrade_rung = self._degrade.rung
        self._degrade.export_gauges(telemetry.get_registry())
        return self._degrade

    def set_degrade_rung(self, rung, reason="forced"):
        """External rung override; arms a default ladder when none is
        configured."""
        if self._degrade is None:
            self.configure_degrade(None)
        return self._degrade.set_rung(rung, reason=reason)

    @property
    def degrade_rung(self):
        return self._degrade_rung

    def _effective_spec_k(self):
        """Speculation after the ladder: rung >= 1 runs the one-token decode."""
        return 0 if self._rung() >= 1 else self._spec_k

    def _on_degrade_change(self, old, new, reason):
        self._degrade_rung = new
        # crossing the speculation boundary switches decode programs:
        # re-upload the lane state (the history mirror is kept warm)
        if self._spec_k > 0 and (old >= 1) != (new >= 1):
            self._lane_dirty = True

    def _degrade_queue_budget(self):
        """Admission-queue budget under the ladder: rung >= 2 halves it."""
        if self._degrade_rung >= 2:
            return max(1, self.config.max_queue // 2)
        return self.config.max_queue

    # -- memory tiering & pressure --------------------------------------
    def _guard_rss_mb(self):
        """The guard's RSS reader: the host_mem_pressure arm substitutes a
        value over the watermark while armed."""
        if self.injector is not None and self.injector.host_mem_pressure_active():
            return self.config.host_mem_watermark_mb * 4.0
        return read_host_rss_mb()

    def _on_spill_event(self, event):
        """Spill-tier listener (runs under the cache lock: metrics and the
        tracer only)."""
        if event == "spill_hit":
            self.metrics.record_spill_lookup(True)
        elif event == "spill_miss":
            self.metrics.record_spill_lookup(False)
        elif event == "spill_corrupt":
            self.metrics.record_spill_corrupt()
            tracer = getattr(self, "_tracer", None)
            if tracer is not None and tracer.enabled:
                tracer.instant("serving/spill_corrupt", cat="serving",
                               args={"total": self.metrics.spill_corrupt_total})

    def _on_mem_pressure_level(self, level, rss_mb):
        tracer = getattr(self, "_tracer", None)
        if tracer is not None and tracer.enabled:
            tracer.instant("serving/mem_pressure", cat="serving", args={
                "level": level, "level_name": MemoryPressureGuard.LEVELS[level],
                "rss_mb": None if rss_mb is None else round(rss_mb, 1)})

    def _relieve_memory_pressure(self):
        """One relief attempt when admission finds the pool exhausted: evict
        every unreferenced live prefix entry (demoting it to the spill tier)
        and shed the spill tier. True when anything was released."""
        if self.prefix_cache is None:
            return False
        self._pool_relief_attempts += 1
        evicted = self.prefix_cache.evict_unreferenced()
        shed = self.prefix_cache.shed_spill()
        return bool(evicted or shed)

    def memtier_stats(self):
        """Spill tier and pressure guard, one dict."""
        out = {"pool_relief_attempts": self._pool_relief_attempts}
        if self.prefix_cache is not None:
            out["prefix_cache"] = self.prefix_cache.stats()
        if self._mem_guard is not None:
            out["mem_guard"] = self._mem_guard.stats()
        return out

    # -- requests -------------------------------------------------------
    def submit(self, prompt_ids, max_new_tokens=None, eos_token_id=None,
               timeout_s=None, stream_cb=None, age_s=0.0):
        """Queue one request; returns its ``ServingFuture``. Raises
        ``QueueFullError`` at capacity (at half of it on degrade rung 2),
        ``EngineDrainingError`` during a planned drain and ``ValueError``
        for requests that can never fit. ``stream_cb(request_id, token)``
        is called for every generated token. ``age_s`` backdates the
        enqueue time: a re-routed request keeps its deadline and TTFT
        clock."""
        self._check_follower("submit")
        self._check_draining()
        if max_new_tokens is None:
            max_new_tokens = self.config.default_max_new_tokens
        prompt = self._check_request(prompt_ids, max_new_tokens, "max_new_tokens",
                                     eos_token_id)
        if self._lockstep:
            # the next plan carries it to every rank
            req = self.scheduler.adopt(
                prompt, max_new_tokens=int(max_new_tokens),
                eos_token_id=None if eos_token_id is None else int(eos_token_id),
                timeout_s=timeout_s, stream_cb=stream_cb,
                submitted_at=_submitted_at(age_s))
            with self._inbox_lock:
                if self.scheduler.queue_depth() + len(self._inbox) >= self.scheduler.max_queue:
                    raise QueueFullError(
                        f"admission queue is full ({self.scheduler.max_queue} waiting); "
                        f"request rejected — retry with backpressure")
                self._inbox.append(req)
            return req.future
        req = self.scheduler.submit(
            prompt, max_new_tokens=int(max_new_tokens),
            eos_token_id=None if eos_token_id is None else int(eos_token_id),
            timeout_s=timeout_s, stream_cb=stream_cb, submitted_at=_submitted_at(age_s))
        return req.future

    def _check_follower(self, what):
        if self._lockstep and not self._lead:
            raise RuntimeError(
                f"{what}() on rank {comm.group_rank(self._plan_group)} of a serving "
                "mesh: requests are submitted on rank 0, which plans every rank's steps")

    def _check_no_mesh(self, what):
        if self.local_heads != self.n_heads:
            raise NotImplementedError(
                f"{what}: the KV handoff on a serving mesh is not ported to "
                "deepspeed_tpu_torch yet (ROADMAP.md, queue 1)")

    def _check_draining(self):
        if self._draining:
            raise EngineDrainingError(
                "engine is draining for a planned restart; "
                "route this request to another replica")

    def _check_request(self, prompt_ids, n_new, what, eos_token_id):
        """A request's prompt as ints, after the checks both submit paths
        share: ids in the vocabulary, the prompt in a bucket, prompt plus
        ``n_new`` within ``max_seq_len``, and the degrade rung's queue
        budget."""
        prompt = [int(t) for t in np.asarray(prompt_ids).reshape(-1)]
        if len(prompt) < 1:
            raise ValueError("prompt must contain at least one token")
        vocab = self.model_config.vocab_size
        if min(prompt) < 0 or max(prompt) >= vocab:
            # an out-of-range id would trip a device-side assert in the
            # embedding gather and take the CUDA context down with it
            raise ValueError(f"prompt token ids must lie in [0, {vocab})")
        if n_new < 1:
            raise ValueError(f"{what} must be >= 1, got {n_new}")
        bucket_for(len(prompt), self.scheduler.buckets)  # raises if too long
        total = len(prompt) + int(n_new)
        if total > self.max_seq_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + {what} ({n_new}) "
                f"= {total} exceeds serving max_seq_len={self.max_seq_len}")
        if eos_token_id is not None and not 0 <= int(eos_token_id) < vocab:
            raise ValueError(f"eos_token_id={eos_token_id} outside vocab [0, {vocab})")
        if self._degrade_rung >= 2:
            budget = self._degrade_queue_budget()
            if self.scheduler.queue_depth() >= budget:
                raise QueueFullError(f"admission queue shrunk to {budget} at degrade "
                                     f"rung {self._degrade_rung}")
        return prompt

    # -- disaggregated prefill/decode handoff ---------------------------
    def submit_handoff(self, prompt_ids, reserve_new_tokens, eos_token_id=None,
                       timeout_s=None, stream_cb=None, age_s=0.0):
        """Prefill-only submit: prefill ``prompt_ids``, emit the first
        token and retire (``max_new_tokens=1``), exporting the lane's
        pages as ``req.export_payload`` for a decode replica.

        ``reserve_new_tokens`` is the original request's generation
        budget: the pages span the whole request, so the exported layout
        (and the int8 scales, taken over the whole allocated span) is the
        one a mixed admission of the original request lays out, bit for
        bit. Returns the Request (read ``export_payload`` after
        ``future.result()``)."""
        self._check_no_mesh("submit_handoff")
        self._check_draining()
        reserve = int(reserve_new_tokens)
        prompt = self._check_request(prompt_ids, reserve, "reserve_new_tokens",
                                     eos_token_id)
        req = self.scheduler.adopt(
            prompt, max_new_tokens=1,
            eos_token_id=None if eos_token_id is None else int(eos_token_id),
            timeout_s=timeout_s, stream_cb=stream_cb, submitted_at=_submitted_at(age_s))
        # flags set before the request becomes visible to the loop
        req.handoff_export = True
        req.alloc_tokens_override = min(len(prompt) + reserve, self.max_seq_len)
        self.scheduler.enqueue(req)
        return req

    def handoff_claim(self, n_tokens):
        """Decode side, phase 1: a pool slot sized for the whole request
        span (PoolExhaustedError under pressure). An armed injector claims
        full lanes, as ``_alloc_tokens`` does, so the claim holds at least
        as many pages as the (also full-lane) export ships."""
        self._check_no_mesh("handoff_claim")
        n = None if self.injector is not None else int(n_tokens)
        return self._run_on_loop(lambda: self.pool.allocate(n))

    def handoff_install(self, slot, meta, frames, handoff_key=None):
        """Decode side, phase 2: install the shipped pages into the
        claimed slot. False on an idempotent duplicate."""
        def _do():
            fresh = self.pool.install_raw(slot, meta, frames, handoff_key=handoff_key)
            self.metrics.record_handoff("install" if fresh else "dup_install")
            return fresh
        return self._run_on_loop(_do)

    def handoff_release(self, slot):
        """Free a claimed or installed slot (orphan reap, failed resume)."""
        return self._run_on_loop(lambda: self.pool.free(slot))

    def resume_handoff(self, slot, prompt_ids, first_token, max_new_tokens,
                       eos_token_id=None, timeout_s=None, stream_cb=None, age_s=0.0):
        """Activate a lane whose pages a handoff installed and decode on
        from where prefill stopped. The first token was delivered by the
        prefill replica: it is recorded (``emitted=1``, on the future) but
        not streamed again. Returns the Request."""
        self._check_no_mesh("resume_handoff")
        prompt = [int(t) for t in np.asarray(prompt_ids).reshape(-1)]
        req = self.scheduler.adopt(
            prompt, max_new_tokens=int(max_new_tokens),
            eos_token_id=None if eos_token_id is None else int(eos_token_id),
            timeout_s=timeout_s, stream_cb=stream_cb, submitted_at=_submitted_at(age_s))

        def _do():
            req.attn_impl = self._impl_for_len(len(prompt))
            now = time.monotonic()
            req.first_token_time = now
            self._activate(req, slot, int(first_token), emit=False)
            req.future._append(int(first_token))
            req.emitted = 1
            self.metrics.record_handoff("resume")
            # retire at once if the first token already ended the request
            self._maybe_retire(req, int(first_token), now)
        self._run_on_loop(_do)
        return req

    # -- the serving loop ----------------------------------------------
    @torch.no_grad()
    def step(self):
        """One scheduler iteration: expire, advance the chunked prefill by
        one chunk, admit (batched per bucket and backend), one batched
        decode step per armed lane class (speculative when armed), retire.
        Returns an activity dict (all zeros = idle); on a mesh, None once
        rank 0 has closed its engine."""
        now = time.monotonic()
        if self._lockstep and self._exchange_plan(now)["stop"]:
            return None
        stats = {"admitted": 0, "decoded": 0, "retired": 0, "prefill_chunks": 0}
        self._drain_loop_ops()
        for req in self.scheduler.pop_expired(self._decision_now(now)):
            self._finish_timeout(req, phase="queued")
            stats["retired"] += 1
        if self._chunking is not None:
            self._advance_chunk(stats)
        self._admit_from_queue(stats)
        if self.injector is not None:
            self.injector.maybe_evict_prefix(self._step_count, self.prefix_cache)
            self.injector.maybe_corrupt_spill(self._step_count, self.prefix_cache)
        if self._mem_guard is not None:
            self._mem_guard.check()
        if self._active:
            self._busy_steps += 1
            if self.injector is not None:
                self.injector.maybe_slow_decode(self._step_count)
                self.injector.maybe_kill_replica(self._busy_steps)
            span_args = None
            if self._tracer.enabled:
                span_args = {"request_ids": [r.id for r in self._active.values()],
                             "active": len(self._active), "accepted": 0}
                dspan = self._tracer.span("serving/decode_step", cat="serving",
                                          args=span_args)
            else:
                dspan = telemetry.NULL_SPAN
            with dspan:
                if self._effective_spec_k() > 0:
                    self._spec_decode(stats, span_args)
                else:
                    self._decode(stats)
        self._step_count += 1
        if not self._lead:
            return stats                 # the ladder and the SLOs are rank 0's
        if self._degrade is not None and self._degrade.config.enabled:
            threshold = max(1, int(self._degrade.config.pressure_queue_frac
                                   * self.config.max_queue))
            self._degrade.update(self.scheduler.queue_depth() >= threshold)
        if self.slo is not None:
            # host values only; under policy "fail" a firing rule raises
            # SloViolationError out of step()
            self.slo.evaluate(self._slo_values())
        return stats

    def _decode(self, stats):
        """One token a lane: each armed class's step, one host read."""
        t0 = time.monotonic()
        if self._lane_dirty:
            self._upload_lane_state()
        tokens, positions = self._dev_tokens, self._dev_positions
        with self._guard():
            for cls, mask in self._dev_active.items():
                tokens, positions = _DECODE_STEPS[cls](
                    self.model, self.pool, self._dev_page_tables, tokens,
                    positions, mask, self.local_heads, self._qmode, self.pool.compute_dtype)
        self._check_decode_sentinels()
        # on a mesh the broadcast stays outside the guard (gloo stages
        # device tensors through the host)
        tokens = self._from_lead(tokens)
        self._dev_tokens, self._dev_positions = tokens, positions
        with self._guard():
            host_tokens = device_get(tokens, _STEP_READ).numpy()   # the step's one host read
        step_s = time.monotonic() - t0
        self._lane_tokens = host_tokens.copy()
        toks = host_tokens.tolist()
        now = time.monotonic()
        n_active = len(self._active)
        for slot in list(self._active):
            req = self._active[slot]
            base = int(self.pool.positions[slot])
            self.pool.advance(slot)
            if self._lane_history is not None:
                # speculation configured but ladder-disabled: keep the
                # drafter's history warm for the way back
                self._lane_history[slot, base + 1] = toks[slot]
            self._emit(req, toks[slot])
            stats["decoded"] += 1
            stats["retired"] += self._maybe_retire(req, toks[slot], now)
        occ = self.pool.occupancy()
        self.metrics.record_step(
            queue_depth=self.scheduler.queue_depth(), active_slots=n_active,
            max_slots=self.pool.max_slots, tokens_this_step=n_active, step_s=step_s,
            pages_in_use=occ["pages_in_use"],
            page_fragmentation=occ["page_fragmentation"])

    def _spec_decode(self, stats, span_args):
        """One speculative step: each armed class drafts, verifies and
        advances its lanes; one host read of every lane's oracle tokens and
        accepted count; then the accepted tokens are emitted lane by lane,
        truncated where a request retires."""
        t0 = time.monotonic()
        if self._lane_dirty:
            self._upload_lane_state()
        self._maybe_update_noise()
        k = self._spec_k
        tokens, positions = self._dev_tokens, self._dev_positions
        pos_host = [int(p) for p in self.pool.positions]
        oracle = torch.zeros((self.pool.max_slots, k + 1), dtype=torch.long,
                             device=self.device)
        accepted = torch.zeros(self.pool.max_slots, dtype=torch.long, device=self.device)
        with self._guard():
            for cls, mask in self._dev_active.items():
                tokens, positions, o, a = _spec_step(
                    self.model, self.pool, self._dev_page_tables, self._dev_history,
                    tokens, positions, pos_host, mask, self._dev_noise, k, self.local_heads,
                    self._qmode, self.pool.compute_dtype, cls)
                oracle = torch.where(mask[:, None], o, oracle)
                accepted = torch.where(mask, a, accepted)
        self._check_decode_sentinels()
        if self._lockstep:
            # rank 0's verdicts: tokens, positions, oracle, accepted, history
            packed = self._from_lead(torch.cat(
                [tokens[:, None], positions[:, None], oracle, accepted[:, None],
                 self._dev_history], dim=1))
            tokens, positions = packed[:, 0], packed[:, 1]
            oracle, accepted = packed[:, 2:k + 3], packed[:, k + 3]
            self._dev_history = packed[:, k + 4:].contiguous()
        self._dev_tokens, self._dev_positions = tokens, positions
        with self._guard():
            host = device_get(torch.cat([oracle, accepted[:, None]], dim=1),
                              _STEP_READ).tolist()   # one read
        step_s = time.monotonic() - t0
        acc_total = sum(host[s][k + 1] for s in self._active)
        if span_args is not None:
            span_args["accepted"] = acc_total
        now = time.monotonic()
        n_active = len(self._active)
        decoded_before = stats["decoded"]
        for slot in list(self._active):
            req = self._active[slot]
            acc = host[slot][k + 1]
            self._lane_tokens[slot] = host[slot][acc]
            base = int(self.pool.positions[slot])
            for j in range(acc + 1):
                tok = host[slot][j]
                self.pool.advance(slot)
                if base + 1 + j < self.max_seq_len:
                    self._lane_history[slot, base + 1 + j] = tok
                self._emit(req, tok)
                stats["decoded"] += 1
                if self._maybe_retire(req, tok, now):
                    # EOS, length or deadline truncates the step's remaining
                    # oracle tokens, where one-token decoding would stop
                    stats["retired"] += 1
                    break
        occ = self.pool.occupancy()
        self.metrics.record_step(
            queue_depth=self.scheduler.queue_depth(), active_slots=n_active,
            max_slots=self.pool.max_slots,
            tokens_this_step=stats["decoded"] - decoded_before, step_s=step_s,
            accepted_tokens=acc_total, proposed_tokens=k * n_active,
            pages_in_use=occ["pages_in_use"],
            page_fragmentation=occ["page_fragmentation"])

    def _maybe_update_noise(self):
        """Swap the draft-noise operand when the corrupt_draft arm fires
        (and back to zeros after)."""
        if self.injector is None:
            return
        noise = self.injector.corrupt_draft_noise(self._step_count, self._spec_k,
                                                  self.model_config.vocab_size)
        if noise is not None:
            self._dev_noise = torch.as_tensor(
                np.broadcast_to(np.asarray(noise, np.int64),
                                (self.pool.max_slots, self._spec_k)).copy(),
                device=self.device)
            self._noise_armed = True
        elif self._noise_armed:
            self._dev_noise = torch.zeros_like(self._dev_noise)
            self._noise_armed = False

    def _upload_lane_state(self):
        """Lane churn: one upload of tokens, positions, page tables, a
        per-class active mask for every class that has live lanes, and the
        drafter history under speculation."""
        dev = self.device
        self._dev_tokens = torch.as_tensor(self._lane_tokens, dtype=torch.long, device=dev)
        self._dev_positions = torch.as_tensor(self.pool.positions, dtype=torch.long,
                                              device=dev)
        self._dev_page_tables = torch.as_tensor(self.pool.page_tables, dtype=torch.int32,
                                                device=dev)
        classes = np.array([LANE_CLASS[i] for i in self._lane_impl], dtype=object)
        self._dev_active = {}
        for cls in _DECODE_STEPS:
            mask = self._lane_active & (classes == cls)
            if mask.any():
                self._dev_active[cls] = torch.as_tensor(mask, device=dev)
        if self._lane_history is not None:
            self._dev_history = torch.as_tensor(self._lane_history, device=dev)
            if self._dev_noise is None:
                self._dev_noise = torch.zeros((self.pool.max_slots, self._spec_k),
                                              dtype=torch.long, device=dev)
        self._lane_dirty = False

    def drain(self, max_steps=None):
        """Step until no request is queued, prefilling or in flight."""
        steps = 0
        while self.pending():
            self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        return steps

    def pending(self):
        """Requests still owed work: queued + chunking + in flight."""
        return (len(self._active) + (1 if self._chunking is not None else 0)
                + self.scheduler.queue_depth() + len(self._inbox))

    def start(self, idle_sleep_s=0.001):
        """Run the serving loop on a daemon thread until ``stop()``."""
        if self._loop_thread is not None:
            raise RuntimeError("serving loop already running")
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                busy = self.step()
                if not any(busy.values()) and not self._active:
                    time.sleep(idle_sleep_s)

        self._loop_thread = threading.Thread(target=loop, name="serving-loop",
                                             daemon=True)
        self._loop_thread.start()

    def stop(self, timeout_s=5.0):
        if self._loop_thread is None:
            return
        self._stop.set()
        self._loop_thread.join(timeout_s)
        self._loop_thread = None
        self._drain_loop_ops()   # release any waiter the loop left behind

    def close(self):
        self.stop()
        if self._lockstep and self._lead and not self._stopped:
            # the followers' loops end on this plan
            self._exchange_plan(time.monotonic(), stop=True)
            self._stopped = True
        self.metrics.close()
        if self.telemetry_server is not None:
            self.telemetry_server.stop()
            self.telemetry_server = None
        if self._trace_file:
            self._tracer.write(self._trace_file)

    @property
    def draining(self):
        return self._draining

    def begin_drain(self):
        """Planned-restart drain: admit nothing more (``submit`` raises
        ``EngineDrainingError``) and step the accepted work to completion.
        A replica flips this on SIGTERM, finishes its lanes and exits
        ``EXIT_PREEMPTED``."""
        self._draining = True

    # -- loop-thread marshaling -----------------------------------------
    def _drain_loop_ops(self):
        """Run the pool ops other threads posted (handoff claim, install,
        free, resume) on the serving-loop thread."""
        while True:
            try:
                fn, done, box = self._loop_ops.get_nowait()
            except _queue_mod.Empty:
                return
            try:
                box.append(("ok", fn()))
            except BaseException as exc:  # marshal, don't kill the loop
                box.append(("err", exc))
            finally:
                done.set()

    def _run_on_loop(self, fn, timeout_s=30.0):
        """Run ``fn`` on the serving-loop thread and return its result
        (its exception is raised here). Runs inline when no background
        loop is alive or when already on the loop thread."""
        t = self._loop_thread
        if t is None or not t.is_alive() or t is threading.current_thread():
            return fn()
        done = threading.Event()
        box = []
        self._loop_ops.put((fn, done, box))
        if not done.wait(timeout_s):
            raise TimeoutError(f"serving loop did not service a marshaled op within "
                               f"{timeout_s}s (loop stalled?)")
        kind, val = box[0]
        if kind == "err":
            raise val
        return val

    # -- admission ------------------------------------------------------
    def _admit_from_queue(self, stats):
        if self._tracer.enabled and self.scheduler.queue_depth() > 0:
            with self._tracer.span("serving/admission", cat="serving",
                                   args={"queue_depth": self.scheduler.queue_depth()}):
                self._admit_from_queue_now(stats)
        else:
            self._admit_from_queue_now(stats)

    def _impl_for_len(self, prompt_len):
        """A request's backend, by its whole prompt's bucket (the prefix
        lookup is filtered by backend, so selection must not depend on it)."""
        return self._impl_map.get(bucket_for(prompt_len, self.scheduler.buckets),
                                  self._impl_default)

    def _alloc_tokens(self, req):
        """Pages claimed at admission: prompt + generation (whole pages).
        Under fault injection a stuck lane may decode past its length, so
        it claims the full lane."""
        if self.injector is not None:
            return None
        # a handoff export claims the original request's whole span
        override = getattr(req, "alloc_tokens_override", None)
        if override is not None:
            return int(override)
        return min(len(req.prompt) + req.max_new_tokens, self.max_seq_len)

    def _admit_from_queue_now(self, stats):
        """Join-at-free-slot admission, batched per bucket and backend: pop
        the FIFO head, gather every queued request sharing its
        (prefix-adjusted) bucket and backend up to the free-slot count,
        prefill them as one call. Long prompts divert to the chunked path,
        one at a time."""
        while self.pool.free_slots > 0:
            head = self.scheduler.pop_next()
            if head is None:
                return
            if not self.pool.can_allocate(self._alloc_tokens(head)):
                # release host-side ballast once before parking the head
                if (not self._relieve_memory_pressure()
                        or not self.pool.can_allocate(self._alloc_tokens(head))):
                    self.scheduler.requeue_front(head)
                    return
            if self._needs_chunking(head):
                if self._chunking is not None:
                    self.scheduler.requeue_front(head)     # the chunk lane is busy
                    return
                if not self._start_chunked(head):
                    return
                stats["admitted"] += 1
                continue
            bucket = bucket_for(self._suffix_len(head), self.scheduler.buckets)
            impl = self._impl_for_len(len(head.prompt))
            group = [head]
            room = min(self.pool.free_slots - 1, self._prefill_batch - 1)
            if room > 0:
                group += self.scheduler.pop_matching(
                    lambda r: (not self._needs_chunking(r)
                               and self._impl_for_len(len(r.prompt)) == impl
                               and bucket_for(self._suffix_len(r),
                                              self.scheduler.buckets) == bucket),
                    room)
            admitted, retired = self._admit_batch(group, bucket, impl)
            stats["admitted"] += admitted
            stats["retired"] += retired
            if admitted < len(group):
                return                       # pages ran out mid-group

    def _prefill_buffers(self):
        if self._prefill_kv is None:
            shape = (self.n_layers, self._prefill_batch, self.local_heads,
                     self.max_seq_len, self.head_dim)
            self._prefill_kv = tuple(
                torch.zeros(shape, dtype=self.pool.compute_dtype, device=self.device)
                for _ in range(2))
        else:
            # zeroed per admission: the int8 install takes its scales over
            # the whole lane span, which must not see an earlier prompt
            for buf in self._prefill_kv:
                buf.zero_()
        return self._prefill_kv

    def _allocate(self, req):
        """A slot and pages for ``req``, with one memory-pressure relief
        attempt; None when the pool cannot hold it."""
        try:
            return self.pool.allocate(self._alloc_tokens(req))
        except PoolExhaustedError:
            if not self._relieve_memory_pressure():
                return None
        try:
            return self.pool.allocate(self._alloc_tokens(req))
        except PoolExhaustedError:
            return None

    def _admit_batch(self, group, bucket, impl):
        """Prefill ``group`` (same bucket and backend) as one
        [max_slots, Sb] call and install each lane into its slot. Slots
        and pages are claimed first; members the pool cannot hold are
        requeued in FIFO order. Prefix hits seed their lanes from the
        prefix cache and prefill the suffix. Returns (admitted,
        retired-on-first-token)."""
        pspan = (self._tracer.span("serving/prefill_batch", cat="serving",
                                   args={"request_ids": [r.id for r in group],
                                         "bucket": bucket})
                 if self._tracer.enabled else telemetry.NULL_SPAN)
        with pspan:
            return self._admit_batch_now(group, bucket, impl)

    def _admit_batch_now(self, group, bucket, impl):
        B = self._prefill_batch
        pt = self.pool.page_tokens
        # the band's blocked attention needs a page-multiple chunk; pad
        # queries' outputs are discarded and their KV is overwritten by
        # decode before it is attendable
        Sb = _round_up(bucket, pt) if impl in _WINDOW_IMPLS else bucket
        ids = np.zeros((B, Sb), np.int64)
        starts = [0] * B
        lens = np.ones(B, np.int64)            # dummy lanes: 1-token no-ops
        plan = []
        for req in group:
            slot = self._allocate(req)
            if slot is None:
                break
            req.attn_impl = impl
            reuse, entry = self._acquire_prefix(req)
            i = len(plan)
            suffix = req.prompt[reuse:]
            ids[i, :len(suffix)] = suffix
            starts[i] = reuse
            lens[i] = len(req.prompt)
            plan.append((req, reuse, entry, slot))
            self.metrics.record_admission(bucket, len(req.prompt))
        for req in reversed(group[len(plan):]):
            self.scheduler.requeue_front(req)
        if not plan:
            return 0, 0
        init_k, init_v = self._prefill_buffers()
        for i, (req, reuse, entry, _slot) in enumerate(plan):
            if reuse > 0:
                ek, ev = self._entry_prefix_kv(entry, reuse)
                init_k[:, i, :, :reuse] = ek
                init_v[:, i, :, :reuse] = ev
        t0 = time.monotonic()
        first = self._run_prefill(self.model, init_k, init_v,
                                  torch.as_tensor(ids, device=self.device), starts, lens, impl)
        first = self._from_lead(first)
        first_host = device_get(first, _FIRST_TOKEN_READ).tolist()   # the TTFT endpoint
        self.metrics.record_prefill(tokens=sum(len(r.prompt) - re for r, re, _, _ in plan),
                                    reused_tokens=sum(re for _, re, _, _ in plan),
                                    requests=len(plan), prefill_s=time.monotonic() - t0)
        now = time.monotonic()
        retired = 0
        for i, (req, reuse, entry, slot) in enumerate(plan):
            self._maybe_insert_prefix(req, reuse, init_k, init_v, lane=i)
            self.pool.install_lane(init_k, init_v, lane=i, slot=slot,
                                   position=len(req.prompt))
            req.prefix_entry = entry
            req.first_token_time = now
            self.metrics.record_first_token(now - req.submit_time)
            self._activate(req, slot, first_host[i])
            retired += self._maybe_retire(req, first_host[i], now)
        return len(plan), retired

    # -- chunked prefill ------------------------------------------------
    def _needs_chunking(self, req):
        chunk = self.config.prefill_chunk_tokens
        return chunk > 0 and self._suffix_len(req) > chunk

    def _start_chunked(self, req):
        """Reserve a slot and pages and a private cache for ``req``;
        ``_advance_chunk`` feeds it one chunk an engine step. False (the
        request requeued) when the pool cannot hold it."""
        req.attn_impl = self._impl_for_len(len(req.prompt))
        reuse, entry = self._acquire_prefix(req)
        req.prefix_entry = entry
        slot = self._allocate(req)
        if slot is None:
            if entry is not None:
                self.prefix_cache.release(entry)
                req.prefix_entry = None
            self.scheduler.requeue_front(req)
            return False
        self.metrics.record_admission(
            bucket_for(self._suffix_len(req), self.scheduler.buckets), len(req.prompt))
        shape = (self.n_layers, 1, self.local_heads, self.max_seq_len, self.head_dim)
        k0 = torch.zeros(shape, dtype=self.pool.compute_dtype, device=self.device)
        v0 = torch.zeros(shape, dtype=self.pool.compute_dtype, device=self.device)
        if reuse > 0:
            ek, ev = self._entry_prefix_kv(entry, reuse)
            k0[:, 0, :, :reuse] = ek
            v0[:, 0, :, :reuse] = ev
        self._chunking = _ChunkedPrefill(req, k0, v0, pos=reuse, reuse=reuse, slot=slot)
        return True

    def _advance_chunk(self, stats):
        """Run the next chunk of the in-flight chunked prefill (the batched
        prefill at B = 1, Sb = chunk); install and activate on the last
        chunk. Only the last chunk reads the device, for its first token."""
        st = self._chunking
        req = st.req
        if req.deadline_exceeded(self._decision_now(time.monotonic())):
            req.slot = st.slot             # hand the reserved slot back
            self._finish_timeout(req, phase="prefill")
            self._chunking = None
            stats["retired"] += 1
            return
        impl = req.attn_impl
        chunk_len = self.config.prefill_chunk_tokens
        # window chunks pad to a page multiple; a chunk's pad KV is
        # overwritten by the next chunk's writes (the last chunk's by decode)
        # before it is attendable
        cw = _round_up(chunk_len, self.pool.page_tokens) if impl in _WINDOW_IMPLS \
            else chunk_len
        chunk = req.prompt[st.pos:st.pos + chunk_len]
        ids = np.zeros((1, cw), np.int64)
        ids[0, :len(chunk)] = chunk
        cspan = (self._tracer.span("serving/prefill_chunk", cat="serving",
                                   args={"request_id": req.id, "pos": st.pos,
                                         "chunk": len(chunk)})
                 if self._tracer.enabled else telemetry.NULL_SPAN)
        t0 = time.monotonic()
        with cspan:
            first = self._run_prefill(self.model, st.k, st.v,
                                      torch.as_tensor(ids, device=self.device), [st.pos],
                                      np.asarray([len(req.prompt)]), impl)
            first = self._from_lead(first)
        st.pos += len(chunk)
        stats["prefill_chunks"] += 1
        self.metrics.record_prefill_chunk()
        if st.pos < len(req.prompt):
            st.prefill_s += time.monotonic() - t0
            return
        first_tok = int(device_get(first, _FIRST_TOKEN_READ)[0])   # the TTFT endpoint
        st.prefill_s += time.monotonic() - t0
        now = time.monotonic()
        self.metrics.record_prefill(tokens=len(req.prompt) - st.reuse,
                                    reused_tokens=st.reuse, requests=1,
                                    prefill_s=st.prefill_s)
        self._maybe_insert_prefix(req, st.reuse, st.k, st.v, lane=0)
        self.pool.install(st.k, st.v, st.slot, position=len(req.prompt))
        req.first_token_time = now
        self.metrics.record_first_token(now - req.submit_time)
        self._activate(req, st.slot, first_tok)
        stats["retired"] += self._maybe_retire(req, first_tok, now)
        self._chunking = None

    # -- prefix cache ---------------------------------------------------
    def _suffix_len(self, req):
        """Tokens a prefill computes for ``req`` after prefix reuse (at
        least 1: the last prompt position makes the first token)."""
        if self.prefix_cache is None:
            return len(req.prompt)
        length, _ = self.prefix_cache.match(req.prompt,
                                            impl=self._impl_for_len(len(req.prompt)))
        return len(req.prompt) - min(length, len(req.prompt) - 1)

    def _acquire_prefix(self, req):
        """Counted, ref-taking lookup at admission: (reused tokens, entry or
        None). The ref is released when the request retires, on every
        path."""
        if self.prefix_cache is None:
            return 0, None
        length, entry = self.prefix_cache.acquire(req.prompt, impl=req.attn_impl)
        reuse = min(length, len(req.prompt) - 1)
        if entry is not None and reuse <= 0:
            self.prefix_cache.release(entry)
            entry, reuse = None, 0
        self.metrics.record_prefix_lookup(hit=reuse > 0)
        return reuse, entry

    def _maybe_insert_prefix(self, req, reuse, k, v, lane):
        """Store the prefilled prompt's KV for later requests (on the host,
        tagged with the backend that produced it: backends differ in low
        bits). Int8 pools store entries quantized per (layer, head).
        Skipped on degrade rung 2, while the memory guard pauses inserts,
        and when an entry already covers the whole prompt."""
        if self.prefix_cache is None or self._rung() >= 2:
            return
        if self._mem_guard is not None and self._mem_guard.inserts_paused:
            return
        n = len(req.prompt)
        if reuse >= n - 1:
            return
        # copies, never views: the prefill buffer is reused (and on the CPU
        # ``.cpu()`` alone would alias it)
        pk = k[:, lane, :, :n].to("cpu", copy=True)
        pv = v[:, lane, :, :n].to("cpu", copy=True)
        if self.pool.kv_cache_dtype == "int8":
            pk, k_scale = quantize_kv(pk)
            pv, v_scale = quantize_kv(pv)
            self.prefix_cache.insert(req.prompt, pk, pv, k_scale=k_scale,
                                     v_scale=v_scale, impl=req.attn_impl)
            return
        self.prefix_cache.insert(req.prompt, pk, pv, impl=req.attn_impl)

    def _entry_prefix_kv(self, entry, reuse):
        """An entry's first ``reuse`` positions in the compute dtype, on the
        device (int8 entries dequantize here, at seed time)."""
        ek, ev = entry.k[:, :, :reuse], entry.v[:, :, :reuse]
        if entry.k_scale is not None:
            dt = self.pool.compute_dtype
            ek = dequantize_kv(ek, entry.k_scale, dt)
            ev = dequantize_kv(ev, entry.v_scale, dt)
        return (ek.to(self.device, self.pool.compute_dtype),
                ev.to(self.device, self.pool.compute_dtype))

    # -- internals ------------------------------------------------------
    def _activate(self, req, slot, first_tok, emit=True):
        req.slot = slot
        self._active[slot] = req
        self._lane_tokens[slot] = first_tok
        self._lane_active[slot] = True
        self._lane_impl[slot] = req.attn_impl
        if self._lane_history is not None:
            # the drafter's history: the prompt by position, then the
            # pending first token at position len(prompt)
            row = self._lane_history[slot]
            row[:] = 0
            row[:len(req.prompt)] = req.prompt
            row[len(req.prompt)] = first_tok
        self._lane_dirty = True
        if emit:
            self._emit(req, first_tok)

    def _emit(self, req, token):
        req.emitted += 1
        req.future._append(token)
        if req.stream_cb is not None:
            try:
                req.stream_cb(req.id, token)
            except Exception:  # a broken callback must not kill the loop
                pass

    def _maybe_retire(self, req, token, now):
        stuck = self.injector is not None and self.injector.request_is_stuck(req.id)
        if req.deadline_exceeded(self._decision_now(now)):
            self._finish_timeout(req, phase="decoding")
            return 1
        if self.scheduler.should_retire(req, token, stuck=stuck) is not None:
            self._release_slot(req)
            req.future._finish()
            self.scheduler.completed += 1
            self.metrics.record_completion()
            if self._tracer.enabled:
                self._tracer.instant("serving/retire", cat="serving",
                                     args={"request_id": req.id, "tokens": req.emitted})
            return 1
        return 0

    def _finish_timeout(self, req, phase):
        self._release_slot(req)
        if self._tracer.enabled:
            self._tracer.instant("serving/retire_timeout", cat="serving",
                                 args={"request_id": req.id, "phase": phase,
                                       "tokens": req.emitted})
        req.future._finish(RequestTimeoutError(
            req.id, req.timeout_s, phase, tokens_done=req.emitted))
        self.scheduler.timed_out += 1
        self.metrics.record_timeout()

    def _release_slot(self, req):
        if req.slot is not None and getattr(req, "handoff_export", False):
            # the lane's pages, copied to the host before the slot is freed;
            # the replica's handoff sender ships them to the decode replica
            try:
                t0 = time.monotonic()
                req.export_payload = self.pool.export_lane(req.slot)
                req.export_s = time.monotonic() - t0
                self.metrics.record_handoff("export")
            except Exception as exc:
                req.export_error = exc
        if req.slot is not None:
            self._lane_active[req.slot] = False
            self._lane_impl[req.slot] = "dense"
            self._lane_dirty = True
            self._active.pop(req.slot, None)
            self.pool.free(req.slot)
            req.slot = None
        if req.prefix_entry is not None and self.prefix_cache is not None:
            self.prefix_cache.release(req.prefix_entry)
            req.prefix_entry = None

    def occupancy(self):
        return self.pool.occupancy()

    def prefix_stats(self):
        """Prefix-cache counters, or None when the cache is disabled."""
        return None if self.prefix_cache is None else self.prefix_cache.stats()
