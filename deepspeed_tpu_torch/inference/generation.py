"""KV-cache autoregressive decoding over a ``GPT2LMHeadModel``.

Port of ``deepspeed_tpu/inference/generation.py``. Prefill is one causal
forward over the whole prompt (``_forward_full``); decode is a Python
loop over positions, each step a loop over the layers against per-layer
KV caches ``[L, B, nh, S, hd]``, which the port updates in place. The
per-layer math mirrors ``DeepSpeedTransformerLayer`` (pre-LN, fused qkv,
exact GELU).

Attention backends: ``"dense"`` (the exact causal forward, the parity
oracle), ``"flash"`` (the same math blockwise with an online softmax in
composed torch ops; its decode step is the dense one), ``"sparse_xla"``
(each query's canonical window plus the anchor page, composed torch
ops: the band kernel's plain version), ``"pallas_decode"`` (the paged
decode-attention kernel over the cache viewed as identity-mapped pages)
and ``"pallas_sparse"`` (the banded sink+window kernel). The backend
names stay those of the JAX package, so a serving config carries over
unchanged.

Speculative decoding's pieces live here too: ``_ngram_draft`` (a bigram
lookup over a lane's own history) and ``_speculative_verify`` (the k+1
positions through one ``_forward_chunk``; the decode kernel is told the
chunk is a decode step, so its rows carry a decode step's bits).

Every projection goes through ``_linear``, which never hands PyTorch's
matmul a single row: on the CPU a one-row product takes a matrix-vector
path that rounds differently from the matrix path, and the
continuous-vs-``generate()`` oracle needs a row's bits not to depend on
how many rows ride with it.

On a tensor-parallel serving mesh the layers' projections are Megatron
layers (``parallel/tp.py``): qkv and ff1 give this rank's columns, so the
helpers split qkv into three equal sections and size a head from them,
and ``_proj`` all-reduces a row-parallel product over the model group
before adding its bias once. Callers pass the rank's head count.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

from deepspeed_tpu_torch import comm, kernels
from deepspeed_tpu_torch.inference.quantization import (
    embed_rows,
    logits_table,
    maybe_dequant,
    table_dtype,
)
from deepspeed_tpu_torch.kernels import sparse_attention as _sa
from deepspeed_tpu_torch.kernels.sparse_attention import (
    SPARSE_BAND,
    _window_base,
    _window_slice_one,
)
from deepspeed_tpu_torch.models.gpt2 import resolve_device
from deepspeed_tpu_torch.parallel.tp import RowParallelLinear
from deepspeed_tpu_torch.profiling.sentinels import (
    device_put,
    records_programs,
    register_allowed_transfer,
)

ATTENTION_IMPLS = ("dense", "flash", "sparse_xla",
                   "pallas_decode", "pallas_sparse")

# Page granularity shared by the sparse window, the kernel key blocks and
# the serving KV pool's pages.
DEFAULT_PAGE_TOKENS = 128

_NEG = -1e30
# a chunk's write plan (host offsets) on its way to the card
_CHUNK_ROWS = register_allowed_transfer("serving/chunk_rows")


def check_impl(attn_impl):
    """Raise for an unknown backend name."""
    if attn_impl not in ATTENTION_IMPLS:
        raise ValueError(
            f"attn_impl must be one of {ATTENTION_IMPLS}, got {attn_impl!r}")


def check_tpu_knob(name, value):
    """``attention_kernel`` and ``kernel_interpret`` pick Pallas vs XLA and
    interpret mode on the TPU; the port has one route per device."""
    if value is not None:
        raise ValueError(
            f"{name}={value!r} is a TPU-only knob (Pallas/XLA selection); "
            f"the port accepts only None")


def _round_up(n, m):
    return -(-int(n) // int(m)) * int(m)


def resolve_page_tokens(page_tokens, max_seq_len):
    """The effective page size for a cache length: never larger than the
    cache and always dividing it (falling back to the gcd)."""
    pt = min(int(page_tokens or DEFAULT_PAGE_TOKENS), int(max_seq_len))
    if max_seq_len % pt:
        pt = math.gcd(pt, int(max_seq_len))
    return max(pt, 1)


def _cache_dtype(model):
    """The dtype the residual stream (and so the KV caches) carries: an
    int8 token table dequantizes to fp32."""
    return torch.promote_types(table_dtype(model.wte), model.wpe.weight.dtype)


def model_device(model):
    return model.wpe.weight.device


def _ln(x, ln):
    return F.layer_norm(x, ln.normalized_shape, ln.weight, ln.bias, ln.eps)


def _linear(x, weight, bias=None):
    """``x @ weight.T + bias`` over any leading dims, with at least two
    rows in the product (see the module docstring)."""
    lead = x.shape[:-1]
    flat = x.reshape(-1, x.shape[-1])
    if flat.shape[0] == 1:
        out = F.linear(flat.expand(2, -1), weight, bias)[:1]
    else:
        out = F.linear(flat, weight, bias)
    return out.reshape(*lead, out.shape[-1])


def _proj(x, lin):
    if isinstance(lin, RowParallelLinear):
        # this rank's input features: the partial product is all-reduced
        # over the model group and the bias added once, after the sum
        y = comm.reduce_from_model_region(_linear(x, lin.weight), lin.group)
        return y if lin.bias is None else y + lin.bias
    return _linear(x, maybe_dequant(lin), lin.bias)


def _qkv_heads(layer, h, nh):
    """The fused qkv projection of h [..., H] as q, k, v each [..., nh,
    hd]: three equal sections of the product (this rank's heads on a
    tensor-parallel mesh), hd from a section's width."""
    q, k, v = _proj(_ln(h, layer.ln_attn), layer.qkv).chunk(3, dim=-1)
    shape = (*q.shape[:-1], nh, q.shape[-1] // nh)
    return q.reshape(shape), k.reshape(shape), v.reshape(shape)


def _logits(model, h):
    return _linear(_ln(h, model.ln_f), logits_table(model.wte, h.dtype))


def _window_finish(layer, h, ctx):
    """attn_out projection + residual + FFN: h [..., H], ctx [..., nh, hd]."""
    h = h + _proj(ctx.reshape(*h.shape[:-1], -1), layer.attn_out)
    f = F.gelu(_proj(_ln(h, layer.ln_ffn), layer.ff1))
    return h + _proj(f, layer.ff2)


def _write_rows(cache_k, cache_v, k, v, pos):
    """Write one row per lane: caches [B, nh, S, hd], k/v [B, nh, hd] at
    positions pos [B]."""
    lanes = torch.arange(k.shape[0], device=k.device)
    cache_k[lanes, :, pos] = k.to(cache_k.dtype)
    cache_v[lanes, :, pos] = v.to(cache_v.dtype)


def _decode_one(layer, h, cache_k, cache_v, pos, nh):
    """One token per lane through one layer against its cache (dense
    attention): h [B, H]; caches [B, nh, S, hd]; pos [B]."""
    q, k, v = _qkv_heads(layer, h, nh)
    _write_rows(cache_k, cache_v, k, v, pos)
    hd = q.shape[-1]
    S = cache_k.shape[2]
    # a CPU 0-dim scale rides into the product as a scalar: no copy to the
    # card, so a guarded decode step (transfer_free) waits on nothing
    scale = 1.0 / torch.sqrt(torch.tensor(float(hd), dtype=h.dtype))
    scores = torch.matmul(q[:, :, None], cache_k.transpose(-1, -2))[:, :, 0] * scale
    valid = torch.arange(S, device=h.device)[None, :] <= pos[:, None]   # [B, S]
    scores = torch.where(valid[:, None], scores, _NEG)
    probs = torch.softmax(scores.float(), dim=-1).to(h.dtype)
    ctx = torch.matmul(probs[:, :, None], cache_v)[:, :, 0]            # [B, nh, hd]
    return _window_finish(layer, h, ctx)


def _decode_one_kernel(layer, h, cache_k, cache_v, pos, nh, pt):
    """`_decode_one` with the paged decode-attention kernel at C = 1 over
    the cache viewed as identity-mapped pages."""
    q, k, v = _qkv_heads(layer, h, nh)
    _write_rows(cache_k, cache_v, k, v, pos)
    ctx = kernels.chunk_attend(q[:, None], cache_k, cache_v, pos[:, None], pt,
                               h.dtype)[:, 0]
    return _window_finish(layer, h, ctx)


def _decode_one_window_kernel(layer, h, cache_k, cache_v, pos, nh, pt):
    """`_decode_one` with the band kernel: each lane attends its canonical
    window plus the anchor page."""
    q, k, v = _qkv_heads(layer, h, nh)
    _write_rows(cache_k, cache_v, k, v, pos)
    ctx = kernels.chunk_band_attend(q[:, None], cache_k, cache_v,
                                    pos[:, None], pt, h.dtype)[:, 0]
    return _window_finish(layer, h, ctx)


def _window_attend(q, cache_k, cache_v, qpos, pt, dtype):
    """Canonical windowed attention in composed torch ops (the
    ``sparse_xla`` backend): q [B, c, nh, hd] at qpos [B, c] over caches
    [B, nh, S, hd]; every query slices its own window and runs the band
    kernel's plain version, so its math is the same however callers chunk."""
    B, c, nh, hd = q.shape
    base = _window_base(qpos.long(), pt)
    flat = lambda x: x.reshape(B * c, *x.shape[2:])
    kw, vw, ks, vs = map(flat, _window_slice_one(cache_k, cache_v, base, pt))
    ctx = _sa._band_attend_torch(q.reshape(B * c, nh, hd).contiguous(), kw, vw, ks, vs,
                                 qpos.reshape(-1).to(torch.int32),
                                 base.reshape(-1).to(torch.int32), dtype)
    return ctx.reshape(B, c, nh, hd)


def _chunk_attend_window(q, cache_k, cache_v, qpos, pt, dtype):
    """`_window_attend` over a whole chunk, pt queries at a time when the
    chunk is a page multiple (bounding the gathered windows)."""
    C = q.shape[1]
    if C % pt == 0 and C > pt:
        return torch.cat([_window_attend(q[:, i:i + pt], cache_k, cache_v,
                                         qpos[:, i:i + pt], pt, dtype)
                          for i in range(0, C, pt)], dim=1)
    return _window_attend(q, cache_k, cache_v, qpos, pt, dtype)


def _decode_one_window(layer, h, cache_k, cache_v, pos, nh, pt):
    """`_decode_one` with the window backend in composed ops."""
    q, k, v = _qkv_heads(layer, h, nh)
    _write_rows(cache_k, cache_v, k, v, pos)
    ctx = _window_attend(q[:, None], cache_k, cache_v, pos[:, None], pt, h.dtype)[:, 0]
    return _window_finish(layer, h, ctx)


def _flash_attend(q, cache_k, cache_v, qpos, pt, dtype):
    """Blockwise online-softmax causal attention in composed torch ops (the
    ``flash`` backend): q [B, C, nh, hd] at qpos [B, C] over caches
    [B, nh, S, hd], S a multiple of ``pt``. A running (max, denominator,
    numerator) in fp32 across key blocks; a fully masked block adds zero
    probability and scales by exp(0) == 1, so extra trailing blocks change
    no bit."""
    B, C, nh, hd = q.shape
    S = cache_k.shape[2]
    if S % pt:
        raise ValueError(f"cache length {S} is not a multiple of page {pt}")
    scale = (1.0 / torch.sqrt(torch.tensor(float(hd), dtype=dtype))).to(q.device)
    qt = q.transpose(1, 2)                                            # [B,nh,C,hd]
    m = torch.full((B, nh, C), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, nh, C), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, nh, C, hd), dtype=torch.float32, device=q.device)
    koff = torch.arange(pt, device=q.device)
    for j in range(S // pt):
        kb = cache_k[:, :, j * pt:(j + 1) * pt]
        vb = cache_v[:, :, j * pt:(j + 1) * pt]
        s = torch.matmul(qt, kb.transpose(-1, -2)) * scale            # [B,nh,C,pt]
        valid = (j * pt + koff)[None, None, None, :] <= qpos[:, None, :, None]
        s = torch.where(valid, s.float(), _NEG)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None]) * valid
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.matmul(p, vb.float())
        m = m_new
    ctx = (acc / torch.clamp_min(l, 1e-30)[..., None]).to(dtype)
    return ctx.transpose(1, 2)                                        # [B,C,nh,hd]


def _embed(model, token, pos):
    wpe = model.wpe.weight
    return embed_rows(model.wte, token) + wpe[pos.clamp(max=wpe.shape[0] - 1)]


def _run_step(model, caches, token, pos, one):
    h = _embed(model, token, pos)
    for l, layer in enumerate(model.layers):
        h = one(layer, h, caches[0][l], caches[1][l], pos)
    return _logits(model, h)


def _step(model, nh, caches, token, pos):
    """Embed one token per lane, run the layers against the caches (updated
    in place), return next-token logits [B, V]. ``pos`` is [B]."""
    return _run_step(model, caches, token, pos,
                     lambda layer, h, ck, cv, p: _decode_one(layer, h, ck, cv, p, nh))


def _step_kernel(model, nh, caches, token, pos, pt):
    """`_step` with the paged decode-attention kernel per layer."""
    return _run_step(
        model, caches, token, pos,
        lambda layer, h, ck, cv, p: _decode_one_kernel(layer, h, ck, cv, p, nh, pt))


def _step_window(model, nh, caches, token, pos, pt):
    """`_step` with the window backend in composed ops (``sparse_xla``)."""
    return _run_step(
        model, caches, token, pos,
        lambda layer, h, ck, cv, p: _decode_one_window(layer, h, ck, cv, p, nh, pt))


def _step_window_kernel(model, nh, caches, token, pos, pt):
    """`_step` with the band kernel per layer."""
    return _run_step(
        model, caches, token, pos,
        lambda layer, h, ck, cv, p: _decode_one_window_kernel(
            layer, h, ck, cv, p, nh, pt))


def _dense_chunk_attend(q, cache_k, cache_v, qpos):
    """Exact causal attention of q [B, C, nh, hd] at qpos [B, C] over the
    caches [B, nh, S, hd]."""
    S = cache_k.shape[2]
    hd = q.shape[-1]
    scale = 1.0 / torch.sqrt(torch.tensor(float(hd), dtype=q.dtype))   # a CPU scalar
    scores = torch.matmul(q.transpose(1, 2), cache_k.transpose(-1, -2)) * scale
    valid = torch.arange(S, device=q.device)[None, None, :] <= qpos[:, :, None]
    scores = torch.where(valid[:, None], scores, _NEG)
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return torch.matmul(probs, cache_v).transpose(1, 2)               # [B,C,nh,hd]


def _chunk_rows(starts, C, S, device):
    """Host-side write plan for a chunk at per-lane offsets ``starts``:
    (lane, cache position, chunk index) of every position that fits the
    cache. Writes past the cache end (a bucket pad running over) are
    dropped, never clamped onto live rows."""
    lanes, cols, idx = [], [], []
    for b, s in enumerate(starts):
        n = max(0, min(C, S - int(s)))
        lanes += [b] * n
        cols += range(int(s), int(s) + n)
        idx += range(n)
    as_t = lambda x: device_put(np.asarray(x, np.int64), device, _CHUNK_ROWS)
    return as_t(lanes), as_t(cols), as_t(idx)


def _chunk_layer(layer, h, cache_k, cache_v, rows, qpos, nh, attend):
    """A chunk of positions through one layer: qkv, the cache writes of
    ``rows`` (from `_chunk_rows`), then every query attends the cache
    under ``attend(q, cache_k, cache_v, qpos)``."""
    q, k, v = _qkv_heads(layer, h, nh)
    lanes, cols, idx = rows
    cache_k[lanes, :, cols] = k[lanes, idx].to(cache_k.dtype)
    cache_v[lanes, :, cols] = v[lanes, idx].to(cache_v.dtype)
    ctx = attend(q, cache_k, cache_v, qpos)
    return _window_finish(layer, h, ctx)


def _forward_chunk(model, n_heads, caches, ids, starts, attn_impl="dense",
                   page_tokens=DEFAULT_PAGE_TOKENS, prefill=True):
    """Causal forward of ``ids`` [B, C] written into ``caches``
    ([L, B, nh, S, hd] pair, updated in place) at per-lane offsets
    ``starts`` (host ints, [B]). Returns the hidden states [B, C, H]
    before the final LN. ``prefill`` names the stage for the decode
    kernel (False for a speculative verify chunk)."""
    B, C = ids.shape
    dev = ids.device
    S = caches[0].shape[3]
    pt = int(page_tokens)
    qpos = (torch.as_tensor(list(starts), dtype=torch.long, device=dev)[:, None]
            + torch.arange(C, device=dev)[None, :])
    rows = _chunk_rows(starts, C, S, dev)
    if attn_impl == "pallas_decode":
        attend = lambda q, ck, cv, qp: kernels.chunk_attend(q, ck, cv, qp, pt, q.dtype,
                                                            prefill=prefill)
    elif attn_impl == "pallas_sparse":
        attend = lambda q, ck, cv, qp: kernels.chunk_band_attend(
            q, ck, cv, qp, pt, q.dtype)
    elif attn_impl == "sparse_xla":
        attend = lambda q, ck, cv, qp: _chunk_attend_window(q, ck, cv, qp, pt, q.dtype)
    elif attn_impl == "flash":
        attend = lambda q, ck, cv, qp: _flash_attend(q, ck, cv, qp, pt, q.dtype)
    else:
        check_impl(attn_impl)
        attend = _dense_chunk_attend
    h = _embed(model, ids, qpos)
    for l, layer in enumerate(model.layers):
        h = _chunk_layer(layer, h, caches[0][l], caches[1][l], rows, qpos,
                         n_heads, attend)
    return h


def _forward_full(model, ids, true_len, n_layers, n_heads, head_dim, total,
                  attn_impl="dense", page_tokens=DEFAULT_PAGE_TOKENS):
    """Full-prompt causal prefill of ``ids`` [B, S] into fresh caches of
    ``total`` positions, with the logits selected at ``true_len - 1``.
    The kernel backends need page-aligned shapes: the band pads the
    prompt to whole pages and allocates at least one full window of
    cache; the decode kernel rounds the cache up to whole pages. Returns
    (caches, last_logits)."""
    B, S = ids.shape
    dtype = _cache_dtype(model)
    cache_len = total
    if attn_impl in ("sparse_xla", "pallas_sparse"):
        pt = int(page_tokens)
        cache_len = max(_round_up(total, pt), (SPARSE_BAND + 1) * pt)
        ids = F.pad(ids, (0, _round_up(S, pt) - S))
    elif attn_impl in ("flash", "pallas_decode"):
        pt = int(page_tokens)
        cache_len = max(_round_up(total, pt), pt)
    shape = (n_layers, B, n_heads, cache_len, head_dim)
    caches = (torch.zeros(shape, dtype=dtype, device=ids.device),
              torch.zeros(shape, dtype=dtype, device=ids.device))
    h = _forward_chunk(model, n_heads, caches, ids, [0] * B,
                       attn_impl=attn_impl, page_tokens=page_tokens)
    idx = torch.clamp(torch.as_tensor(true_len, device=ids.device).reshape(-1)
                      .expand(B) - 1, 0, S - 1)
    h_last = h[torch.arange(B, device=ids.device), idx]
    return caches, _logits(model, h_last)


def _ngram_draft(history, pos, k):
    """Self-drafting proposal for lanes: ``k`` draft tokens a lane from a
    bigram (prompt-lookup) match over its own token history; no second
    model. ``history`` [B, S] holds each lane's tokens by position,
    ``history[b, pos[b]]`` the pending token. The latest earlier occurrence
    of the bigram ``(history[pos-1], history[pos])`` proposes the tokens
    that followed it, cycling the matched stretch so no read goes past
    ``pos`` (entries above it hold rejected speculation); with no match,
    ``k`` repeats of the pending token. JAX's ``_ngram_draft`` for every
    lane at once."""
    B, S = history.shape
    dev = history.device
    pos = pos.long().reshape(B)
    lanes = torch.arange(B, device=dev)
    j = torch.arange(S - 1, device=dev)[None, :]
    prev = history[lanes, torch.clamp_min(pos - 1, 0)]
    cur = history[lanes, pos]
    m = ((j + 1 < pos[:, None]) & (history[:, :-1] == prev[:, None])
         & (history[:, 1:] == cur[:, None]))
    jstar = torch.where(m, j, -1).amax(dim=1)
    period = torch.clamp_min(pos - jstar - 1, 1)
    idx = jstar[:, None] + 2 + torch.arange(k, device=dev)[None, :] % period[:, None]
    cont = history.gather(1, torch.clamp(idx, 0, S - 1))
    return torch.where(m.any(dim=1)[:, None], cont, cur[:, None].expand(B, k))


def _speculative_verify(model, n_heads, caches, tokens, drafts, positions,
                        attn_impl="dense", page_tokens=DEFAULT_PAGE_TOKENS):
    """Verify ``k`` drafts a lane in one causal forward: the pending
    ``tokens`` [B] and ``drafts`` [B, k] run through ``_forward_chunk`` at
    each lane's next write index ``positions`` (host ints, [B]), giving the
    greedy ``oracle`` [B, k+1]; ``accepted`` [B] counts the leading drafts
    that match it. Everything emitted comes from the oracle, so a wrong
    draft changes only how many tokens a step yields. Rejected drafts leave
    stale KV above the accepted point, which the next step's k+1 writes
    overwrite before anything attends to it, so advancing the position by
    accepted + 1 is the whole rollback."""
    k = drafts.shape[1]
    ids = torch.cat([tokens[:, None], drafts], dim=1)
    h = _forward_chunk(model, n_heads, caches, ids, positions, attn_impl=attn_impl,
                       page_tokens=page_tokens, prefill=False)
    oracle = torch.argmax(_logits(model, h), dim=-1)                  # [B, k+1]
    ok = (drafts == oracle[:, :k]).long()
    accepted = torch.cumprod(ok, dim=1).sum(dim=1)
    return oracle, accepted


def filter_logits(logits, top_k=0, top_p=1.0):
    """Keep the ``top_k`` highest logits (0 = disabled), then the smallest
    set whose renormalized probabilities reach ``top_p`` (1.0 = disabled);
    everything else goes to -1e30. Call after temperature scaling."""
    logits = logits.float()
    V = logits.shape[-1]
    order = torch.argsort(-logits, dim=-1, stable=True)
    ranks = torch.argsort(order, dim=-1)
    k = top_k if top_k > 0 else V
    logits = torch.where(ranks < k, logits, _NEG)
    sorted_logits = torch.gather(logits, -1, order)
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1) - probs
    keep_sorted = (cum < top_p) | (top_p >= 1.0)
    keep = torch.gather(keep_sorted, -1, ranks)
    return torch.where(keep, logits, _NEG)


@records_programs(traced=("prompt_ids",))
def generate(model, config, prompt_ids, max_new_tokens, temperature=0.0,
             rng=None, top_k=0, top_p=1.0, attn_impl="dense",
             kv_page_tokens=None, attention_kernel=None, kernel_interpret=None,
             device="cuda"):
    """Generate ``max_new_tokens`` continuations of ``prompt_ids`` [B, S]
    with ``model`` (a ``GPT2LMHeadModel`` already on ``device``).

    ``temperature=0`` -> greedy argmax; otherwise categorical sampling
    from ``rng`` (a ``torch.Generator`` on ``device``, required), filtered
    by ``top_k``/``top_p``. Returns [B, max_new_tokens] int64 on
    ``device``. ``device`` defaults to CUDA and raises without a card."""
    if temperature < 0.0:
        raise ValueError(f"temperature must be >= 0, got {temperature}")
    if temperature != 0.0 and rng is None:
        raise ValueError("sampling (temperature > 0) requires rng")
    if top_k < 0 or top_k > config.vocab_size:
        raise ValueError(f"top_k must be in [0, {config.vocab_size}], got {top_k}")
    if not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    check_impl(attn_impl)
    check_tpu_knob("attention_kernel", attention_kernel)
    check_tpu_knob("kernel_interpret", kernel_interpret)
    if kv_page_tokens is not None and (
            isinstance(kv_page_tokens, bool)
            or not isinstance(kv_page_tokens, int) or kv_page_tokens < 1):
        raise ValueError(f"kv_page_tokens must be an int >= 1, got {kv_page_tokens!r}")
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    device = resolve_device(device)
    if model_device(model) != device:
        raise ValueError(f"model is on {model_device(model)}, not {device}")
    prompt_ids = torch.as_tensor(prompt_ids, dtype=torch.long)
    if prompt_ids.numel() and (int(prompt_ids.min()) < 0
                               or int(prompt_ids.max()) >= config.vocab_size):
        raise ValueError(f"prompt token ids must lie in [0, {config.vocab_size})")
    prompt_ids = prompt_ids.to(device)
    B, S = prompt_ids.shape
    total = S + int(max_new_tokens)
    if total > config.max_position_embeddings:
        raise ValueError(
            f"prompt ({S}) + max_new_tokens ({max_new_tokens}) = {total} exceeds "
            f"max_position_embeddings={config.max_position_embeddings}")
    nh = config.num_attention_heads
    pt = int(kv_page_tokens or DEFAULT_PAGE_TOKENS)
    if attn_impl == "pallas_decode":
        step = lambda c, t, p: _step_kernel(model, nh, c, t, p, pt)
    elif attn_impl == "pallas_sparse":
        step = lambda c, t, p: _step_window_kernel(model, nh, c, t, p, pt)
    elif attn_impl == "sparse_xla":
        step = lambda c, t, p: _step_window(model, nh, c, t, p, pt)
    else:
        # flash decode is dense decode: one query against the whole cache
        # has no blockwise savings
        step = lambda c, t, p: _step(model, nh, c, t, p)
    out = []
    with torch.inference_mode():
        caches, logits = _forward_full(
            model, prompt_ids, S, config.num_hidden_layers, nh,
            config.hidden_size // nh, total, attn_impl=attn_impl, page_tokens=pt)
        for i, pos in enumerate(range(S, total)):
            if temperature == 0.0:
                token = torch.argmax(logits, dim=-1)
            else:
                scaled = logits.float() / max(temperature, 1e-8)
                if top_k > 0 or top_p < 1.0:
                    scaled = filter_logits(scaled, top_k, top_p)
                token = torch.multinomial(torch.softmax(scaled, dim=-1), 1,
                                          generator=rng)[:, 0]
            out.append(token)
            if i + 1 < max_new_tokens:
                logits = step(caches, token,
                              torch.full((B,), pos, dtype=torch.long, device=device))
    return torch.stack(out, dim=1)


def greedy_generate(model, config, prompt_ids, max_new_tokens, device="cuda"):
    """Greedy ``generate`` (the JAX package's shorthand)."""
    return generate(model, config, prompt_ids, max_new_tokens, device=device)
