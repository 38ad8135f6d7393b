"""Banded sink+window attention: the CUDA kernel ``csrc/band_attention.cu``
and its plain PyTorch version.

Port of ``deepspeed_tpu/kernels/sparse_attention.py``. Every query
attends its canonical window of (SPARSE_BAND+1) pages ending at its own
page plus the anchor (sink) page 0. The window slicing stays outside the
kernel (``_band_block``), so one entry point serves the contiguous
``generate()`` caches and the serving pool's gathered windows; the band
math (both score products, the masks, the fp32 softmax and the PV sum)
is the kernel.

``band_attend`` launches the kernel for CUDA tensors and runs
``_band_attend_torch`` for CPU tensors. The plain version is the JAX
fallback's shared ``_band_math`` with the per-query ``lax.map`` written
out as a batch dimension: every query is computed independently, so its
bits do not depend on how callers batch or chunk the queries.
"""

import torch

from deepspeed_tpu_torch.kernels import build, registry

SPARSE_BAND = 1
_NEG = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


# The port's own copies of the window helpers of
# deepspeed_tpu/inference/generation.py: generation imports this module,
# so importing them from there would make a cycle.
def _window_base(pos, pt):
    """First token of a query's canonical window: SPARSE_BAND pages below
    the query's own page, clamped at 0."""
    return torch.clamp_min(torch.div(pos, pt, rounding_mode="floor")
                           - SPARSE_BAND, 0) * pt


def _window_slice_one(cache_k, cache_v, base, pt):
    """Window slices for per-query bases: caches [B, nh, S, hd] and base
    [B, c] -> k/v windows [B, c, nh, W, hd] starting at each base (the
    start clamped so the slice fits, as a dynamic slice does) and the
    anchor page pair [B, c, nh, pt, hd] (tokens [0, pt)) for every query,
    each gathered straight into that layout."""
    B, nh, S, hd = cache_k.shape
    dev = base.device
    W = (SPARSE_BAND + 1) * pt
    start = torch.clamp(base, 0, S - W)
    win = start[:, :, None, None] + torch.arange(W, device=dev)       # [B,c,1,W]
    sink = torch.arange(pt, device=dev).expand(*base.shape, 1, pt)    # [B,c,1,pt]
    lanes = torch.arange(B, device=dev)[:, None, None, None]
    heads = torch.arange(nh, device=dev)[None, None, :, None]
    return (cache_k[lanes, heads, win], cache_v[lanes, heads, win],
            cache_k[lanes, heads, sink], cache_v[lanes, heads, sink])


def _band_math(q, k_win, v_win, k_sink, v_sink, win_valid, sink_valid, dtype):
    """Band attention for N independent queries: q [N, nh, hd];
    k_win/v_win [N, nh, W, hd]; k_sink/v_sink [N, nh, pt, hd]; win_valid
    [N, 1, W] (window key pos <= query pos); sink_valid [N, 1, pt] (sink
    key pos < window base). Scores in ``dtype``, softmax in fp32, the
    probabilities cast back to ``dtype`` before the PV product."""
    hd = q.shape[-1]
    scale = (1.0 / torch.sqrt(torch.tensor(float(hd), dtype=dtype))).to(q.device)
    qr = q.unsqueeze(-2)                                           # [N,nh,1,hd]
    s_win = torch.matmul(qr, k_win.transpose(-1, -2)).squeeze(-2) * scale
    s_win = torch.where(win_valid, s_win, _NEG)
    s_sink = torch.matmul(qr, k_sink.transpose(-1, -2)).squeeze(-2) * scale
    s_sink = torch.where(sink_valid, s_sink, _NEG)
    s = torch.cat([s_sink, s_win], dim=-1).float()
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - m)
    probs = (e / e.sum(-1, keepdim=True)).to(dtype)
    v_all = torch.cat([v_sink, v_win], dim=-2)                     # [N,nh,pt+W,hd]
    return torch.matmul(probs.unsqueeze(-2), v_all).squeeze(-2)    # [N, nh, hd]


def _band_attend_torch(q, k_win, v_win, k_sink, v_sink, pos, base, dtype):
    W = k_win.shape[2]
    pt = k_sink.shape[2]
    dev = q.device
    win_valid = (base[:, None] + torch.arange(W, device=dev)) <= pos[:, None]
    sink_valid = torch.arange(pt, device=dev)[None, :] < base[:, None]
    return _band_math(q, k_win, v_win, k_sink, v_sink, win_valid[:, None],
                      sink_valid[:, None], dtype)


def _band_attend_cuda(q, k_win, v_win, k_sink, v_sink, pos, base, dtype):
    N, nh, hd = q.shape
    W = k_win.shape[2]
    pt = k_sink.shape[2]
    dev = q.device
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"band_attend: dtype {q.dtype} not supported "
                         "(float32 or bfloat16)")
    if dtype != q.dtype:
        raise ValueError(f"band_attend: output dtype {dtype} must equal the "
                         f"query dtype {q.dtype}")
    if hd not in (64, 128):
        raise ValueError(f"band_attend: head dim {hd} not supported (64, 128)")
    for name, t, shape in (("k_win", k_win, (N, nh, W, hd)),
                           ("v_win", v_win, (N, nh, W, hd)),
                           ("k_sink", k_sink, (N, nh, pt, hd)),
                           ("v_sink", v_sink, (N, nh, pt, hd))):
        if tuple(t.shape) != shape or t.dtype != q.dtype:
            raise ValueError(f"band_attend: {name} is {tuple(t.shape)} "
                             f"{t.dtype}, expected {shape} {q.dtype}")
    if pos.shape != (N,) or base.shape != (N,):
        raise ValueError("band_attend: pos and base must be [N]")
    for t in (q, k_win, v_win, k_sink, v_sink, pos, base):
        if t.device != dev:
            raise ValueError(f"band_attend: tensor on {t.device}, query on {dev}")
        if not t.is_contiguous():
            raise ValueError("band_attend: every input must be contiguous")
    for t in (q, k_win, v_win, k_sink, v_sink):
        if t.data_ptr() % 16:
            raise ValueError("band_attend: the kernel reads 16 bytes at a time; every "
                             "query, key and value tensor must start on a 16-byte boundary")
    out = torch.empty_like(q)
    scale = float(1.0 / torch.sqrt(torch.tensor(float(hd), dtype=dtype)))
    lib = build.load_library()
    with torch.cuda.device(dev):
        rc = lib.ds_band_attend(
            q.data_ptr(), k_win.data_ptr(), v_win.data_ptr(),
            k_sink.data_ptr(), v_sink.data_ptr(), pos.data_ptr(),
            base.data_ptr(), out.data_ptr(), N, nh, hd, W, pt,
            _DTYPE_CODES[q.dtype], scale,
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, "sparse_attention")
    registry.record_launch("sparse_attention")
    return out


def band_attend(q, k_win, v_win, k_sink, v_sink, pos, base, *, dtype):
    """Banded sink+window attention for N independent queries: q
    [N, nh, hd] against window slices k_win/v_win [N, nh, W, hd] (tokens
    [base, base+W) per query) plus the anchor page k_sink/v_sink
    [N, nh, pt, hd] (tokens [0, pt)); ``pos``/``base`` are [N]. Returns
    [N, nh, hd]. CUDA tensors launch the kernel, CPU tensors run the
    plain version."""
    q, k_win, v_win, k_sink, v_sink = (
        t.contiguous() for t in (q, k_win, v_win, k_sink, v_sink))
    pos = pos.to(torch.int32).contiguous()
    base = base.to(torch.int32).contiguous()
    if q.device.type == "cpu":
        return _band_attend_torch(q, k_win, v_win, k_sink, v_sink, pos, base,
                                  dtype)
    if q.device.type != "cuda":
        raise ValueError(f"band_attend: no kernel for device {q.device}")
    return _band_attend_cuda(q, k_win, v_win, k_sink, v_sink, pos, base, dtype)


def _band_block(qb, pb, cache_k, cache_v, pt, dtype):
    """One block of queries through the band: qb [B, c, nh, hd] at
    positions pb [B, c] against per-lane caches [B, nh, S, hd]. The window
    slicing is plain tensor indexing; the flattened [B*c] queries then
    run the band kernel."""
    B, c, nh, hd = qb.shape
    base = _window_base(pb.long(), pt)                             # [B, c]
    flat = lambda x: x.reshape(B * c, *x.shape[2:])
    kw, vw, ks, vs = map(flat, _window_slice_one(cache_k, cache_v, base, pt))
    ctx = band_attend(qb.reshape(B * c, nh, hd), kw, vw, ks, vs,
                      pb.reshape(B * c), base.reshape(B * c), dtype=dtype)
    return ctx.reshape(B, c, nh, hd)


def chunk_band_attend(q, cache_k, cache_v, qpos, page_tokens, dtype):
    """Whole-chunk band attention: q [B, C, nh, hd] at positions qpos
    [B, C] over the already-written caches [B, nh, S, hd]. A chunk that is
    a multiple of the page size runs pt queries at a time (bounding the
    gathered window slices to one block); any other chunk runs at once.
    Each query slices its own canonical window either way, so its math is
    the decode step's whatever the chunking."""
    B, C, nh, hd = q.shape
    pt = int(page_tokens)
    if C % pt == 0 and C > pt:
        return torch.cat([_band_block(q[:, i:i + pt], qpos[:, i:i + pt],
                                      cache_k, cache_v, pt, dtype)
                          for i in range(0, C, pt)], dim=1)
    return _band_block(q, qpos, cache_k, cache_v, pt, dtype)
