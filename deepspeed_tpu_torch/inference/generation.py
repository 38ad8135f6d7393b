"""KV-cache autoregressive decoding over a ``GPT2LMHeadModel``.

Port of ``deepspeed_tpu/inference/generation.py``. Prefill is one causal
forward over the whole prompt (``_forward_full``); decode is a Python
loop over positions, each step a loop over the layers against per-layer
KV caches ``[L, B, nh, S, hd]``, which the port updates in place. The
per-layer math mirrors ``DeepSpeedTransformerLayer`` (pre-LN, fused qkv,
exact GELU).

Attention backends ported so far: ``"dense"`` (the exact causal forward,
the parity oracle), ``"pallas_decode"`` (the paged decode-attention
kernel over the cache viewed as identity-mapped pages) and
``"pallas_sparse"`` (the banded sink+window kernel). The backend names
stay those of the JAX package, so a serving config carries over
unchanged. ``"flash"`` and ``"sparse_xla"`` raise NotImplementedError.

Every projection goes through ``_linear``, which never hands PyTorch's
matmul a single row: on the CPU a one-row product takes a matrix-vector
path that rounds differently from the matrix path, and the
continuous-vs-``generate()`` oracle needs a row's bits not to depend on
how many rows ride with it.
"""

import math

import torch
import torch.nn.functional as F

from deepspeed_tpu_torch import kernels
from deepspeed_tpu_torch.inference.quantization import (
    embed_rows,
    logits_table,
    maybe_dequant,
)
from deepspeed_tpu_torch.kernels.sparse_attention import SPARSE_BAND
from deepspeed_tpu_torch.models.gpt2 import resolve_device

ATTENTION_IMPLS = ("dense", "flash", "sparse_xla",
                   "pallas_decode", "pallas_sparse")

# Page granularity shared by the sparse window, the kernel key blocks and
# the serving KV pool's pages.
DEFAULT_PAGE_TOKENS = 128

_NEG = -1e30


def check_ported(attn_impl):
    """Raise for a backend name the port does not run yet."""
    if attn_impl not in ATTENTION_IMPLS:
        raise ValueError(
            f"attn_impl must be one of {ATTENTION_IMPLS}, got {attn_impl!r}")
    if attn_impl in ("flash", "sparse_xla"):
        raise NotImplementedError(
            f"attn_impl={attn_impl!r} is not ported yet (ROADMAP.md, queue 1: "
            f"the serving features left out of the first slice)")


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
    """The dtype the residual stream (and so the KV caches) carries."""
    return torch.promote_types(model.wte.weight.dtype, model.wpe.weight.dtype)


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
    return _linear(x, maybe_dequant(lin), lin.bias)


def _logits(model, h):
    return _linear(_ln(h, model.ln_f), logits_table(model.wte, h.dtype))


def _window_qkv(layer, h, nh):
    """The fused qkv projection for one token per lane: h [B, H] ->
    q, k, v each [B, nh, hd]."""
    B, H = h.shape
    q, k, v = _proj(_ln(h, layer.ln_attn), layer.qkv).split(H, dim=-1)
    return (q.reshape(B, nh, H // nh), k.reshape(B, nh, H // nh),
            v.reshape(B, nh, H // nh))


def _window_finish(layer, h, ctx):
    """attn_out projection + residual + FFN: h [..., H], ctx [..., nh, hd]."""
    h = h + _proj(ctx.reshape(h.shape), layer.attn_out)
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
    q, k, v = _window_qkv(layer, h, nh)
    _write_rows(cache_k, cache_v, k, v, pos)
    hd = q.shape[-1]
    S = cache_k.shape[2]
    scale = (1.0 / torch.sqrt(torch.tensor(float(hd), dtype=h.dtype))).to(h.device)
    scores = torch.matmul(q[:, :, None], cache_k.transpose(-1, -2))[:, :, 0] * scale
    valid = torch.arange(S, device=h.device)[None, :] <= pos[:, None]   # [B, S]
    scores = torch.where(valid[:, None], scores, _NEG)
    probs = torch.softmax(scores.float(), dim=-1).to(h.dtype)
    ctx = torch.matmul(probs[:, :, None], cache_v)[:, :, 0]            # [B, nh, hd]
    return _window_finish(layer, h, ctx)


def _decode_one_kernel(layer, h, cache_k, cache_v, pos, nh, pt):
    """`_decode_one` with the paged decode-attention kernel at C = 1 over
    the cache viewed as identity-mapped pages."""
    q, k, v = _window_qkv(layer, h, nh)
    _write_rows(cache_k, cache_v, k, v, pos)
    ctx = kernels.chunk_attend(q[:, None], cache_k, cache_v, pos[:, None], pt,
                               h.dtype)[:, 0]
    return _window_finish(layer, h, ctx)


def _decode_one_window_kernel(layer, h, cache_k, cache_v, pos, nh, pt):
    """`_decode_one` with the band kernel: each lane attends its canonical
    window plus the anchor page."""
    q, k, v = _window_qkv(layer, h, nh)
    _write_rows(cache_k, cache_v, k, v, pos)
    ctx = kernels.chunk_band_attend(q[:, None], cache_k, cache_v,
                                    pos[:, None], pt, h.dtype)[:, 0]
    return _window_finish(layer, h, ctx)


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
    scale = (1.0 / torch.sqrt(torch.tensor(float(hd), dtype=q.dtype))).to(q.device)
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
    as_t = lambda x: torch.tensor(x, dtype=torch.long, device=device)
    return as_t(lanes), as_t(cols), as_t(idx)


def _chunk_layer(layer, h, cache_k, cache_v, rows, qpos, nh, attend):
    """A chunk of positions through one layer: qkv, the cache writes of
    ``rows`` (from `_chunk_rows`), then every query attends the cache
    under ``attend(q, cache_k, cache_v, qpos)``."""
    B, C, H = h.shape
    hd = H // nh
    q, k, v = _proj(_ln(h, layer.ln_attn), layer.qkv).split(H, dim=-1)
    q = q.reshape(B, C, nh, hd)
    lanes, cols, idx = rows
    cache_k[lanes, :, cols] = k.reshape(B, C, nh, hd)[lanes, idx].to(cache_k.dtype)
    cache_v[lanes, :, cols] = v.reshape(B, C, nh, hd)[lanes, idx].to(cache_v.dtype)
    ctx = attend(q, cache_k, cache_v, qpos)
    return _window_finish(layer, h, ctx)


def _forward_chunk(model, n_heads, caches, ids, starts, attn_impl="dense",
                   page_tokens=DEFAULT_PAGE_TOKENS):
    """Causal forward of ``ids`` [B, C] written into ``caches``
    ([L, B, nh, S, hd] pair, updated in place) at per-lane offsets
    ``starts`` (host ints, [B]). Returns the hidden states [B, C, H]
    before the final LN."""
    B, C = ids.shape
    dev = ids.device
    S = caches[0].shape[3]
    pt = int(page_tokens)
    qpos = (torch.as_tensor(list(starts), dtype=torch.long, device=dev)[:, None]
            + torch.arange(C, device=dev)[None, :])
    rows = _chunk_rows(starts, C, S, dev)
    if attn_impl == "pallas_decode":
        attend = lambda q, ck, cv, qp: kernels.chunk_attend(q, ck, cv, qp, pt, q.dtype,
                                                            prefill=True)
    elif attn_impl == "pallas_sparse":
        attend = lambda q, ck, cv, qp: kernels.chunk_band_attend(
            q, ck, cv, qp, pt, q.dtype)
    else:
        check_ported(attn_impl)
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
    if attn_impl == "pallas_sparse":
        pt = int(page_tokens)
        cache_len = max(_round_up(total, pt), (SPARSE_BAND + 1) * pt)
        ids = F.pad(ids, (0, _round_up(S, pt) - S))
    elif attn_impl == "pallas_decode":
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
    check_ported(attn_impl)
    check_tpu_knob("attention_kernel", attention_kernel)
    check_tpu_knob("kernel_interpret", kernel_interpret)
    if kv_page_tokens is not None and (
            isinstance(kv_page_tokens, bool)
            or not isinstance(kv_page_tokens, int) or kv_page_tokens < 1):
        raise ValueError(f"kv_page_tokens must be an int >= 1, got {kv_page_tokens!r}")
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    device = resolve_device(device)
    if model.wte.weight.device != device:
        raise ValueError(f"model is on {model.wte.weight.device}, not {device}")
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
    else:
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

