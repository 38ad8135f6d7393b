"""Paged causal decode attention: the CUDA kernel
``csrc/decode_attention.cu`` and its plain PyTorch version.

Port of ``deepspeed_tpu/kernels/decode_attention.py``. Queries
q [B, C, nh, hd] at positions qpos [B, C] attend over a page pool
pages_k/v [P, nh, pt, hd] through per-lane page tables [B, mp] with the
masked online-softmax recurrence of ``_page_update`` (key position <=
query position, -1e30 sentinel, running max / denominator / numerator in
fp32). int8 pages carry per-(page, head) scales that multiply the QK dot
and the PV sum, so no dequantized page copy exists.

``decode_attend`` launches the kernel for CUDA tensors and runs the plain
version ``_decode_attend_torch`` for CPU tensors; nothing falls back from
one to the other. The kernel cuts every lane's cache into splits of a
fixed number of keys (``split_plan``), one block per split, and a second
small device kernel merges a query's partial (m, l, acc) in ascending key
order (``_merge_partial`` is that merge in PyTorch); the wrapper
allocates the partials' scratch. bf16 queries have two routines, one for
a decode step and one for a prompt's chunk, and the caller names the stage
(``prefill``), so that a one-token prompt takes the chunk routine like any
wider prefill: serving (bucket-wide chunks) and ``generate()`` (exact
lengths) then run the same routine at the same stage of a request.

The plain version mirrors the JAX fallback op for op (a loop per lane and
per page around the shared ``_page_update``), with one addition: queries
run in zero-padded tiles of ``_QTILE``, so every query's dot products go
through one fixed matmul shape whatever the chunk width. PyTorch's CPU
matmuls pick their blocking by shape, and the fixed tile keeps a query's
bits the same in a prefill chunk, a decode step and a serving lane: the
continuous-vs-``generate()`` oracle rests on that.
"""

import math

import torch

from deepspeed_tpu_torch.kernels import build, registry

_QTILE = 8
_NEG = -1e30
_SPLIT_KEYS = 256   # the kernel's kMaxSplitKeys: a split is whole pages, at most this long
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def _attn_scale(hd, dtype, quant):
    """1/sqrt(hd) in the dtype the QK product runs in: the compute dtype
    for fp pages, fp32 for int8 pages (the scale rides with the fp32
    dot)."""
    return 1.0 / torch.sqrt(torch.tensor(float(hd),
                                         dtype=torch.float32 if quant else dtype))


def _page_update(qb, kb, vb, valid, m, l, acc, scale, sk=None, sv=None):
    """One page of the online-softmax recurrence for a lane's query tiles.

    qb [nt, nh, T, hd] (compute dtype); kb/vb [nh, pt, hd] (storage
    dtype, fp or int8); valid [nt, 1, T, pt] bool; carry m/l
    [nt, nh, T] f32 and acc [nt, nh, T, hd] f32; ``sk``/``sv`` the page's
    per-head int8 scales [nh] (None for fp pages). Masked keys add
    exp(-1e30 - m) == 0 probability and leave the running max alone."""
    if sk is None:
        s = torch.matmul(qb, kb.to(qb.dtype).transpose(-1, -2)) * scale
        s = s.float()
    else:
        s = (torch.matmul(qb.float(), kb.float().transpose(-1, -2))
             * (sk[:, None, None] * scale))
    s = torch.where(valid, s, _NEG)
    m_new = torch.maximum(m, s.amax(-1))
    p = torch.exp(s - m_new[..., None]) * valid
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(-1)
    pv = torch.matmul(p, vb.float())
    if sv is not None:
        pv = pv * sv[:, None, None]
    acc = acc * corr[..., None] + pv
    return m_new, l, acc


def _decode_attend_torch(q, pages_k, pages_v, tables, qpos, pt, dtype,
                         k_scale, v_scale):
    """Plain version: a loop over lanes and, inside, over the lane's page
    table, each page one ``_page_update`` of all the lane's query tiles."""
    B, C, nh, hd = q.shape
    mp = tables.shape[1]
    quant = k_scale is not None
    scale = _attn_scale(hd, dtype, quant).to(q.device)
    nt = -(-C // _QTILE)
    pad = nt * _QTILE - C
    qt = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad))
    qt = qt.reshape(B, nt, _QTILE, nh, hd).permute(0, 1, 3, 2, 4)
    qp = torch.nn.functional.pad(qpos, (0, pad), value=-1)
    qp = qp.reshape(B, nt, _QTILE)
    tab = tables.tolist()
    koff = torch.arange(pt, device=q.device)
    out = []
    for b in range(B):
        m = torch.full((nt, nh, _QTILE), _NEG, dtype=torch.float32, device=q.device)
        l = torch.zeros((nt, nh, _QTILE), dtype=torch.float32, device=q.device)
        acc = torch.zeros((nt, nh, _QTILE, hd), dtype=torch.float32,
                          device=q.device)
        for j in range(mp):
            pid = tab[b][j]
            valid = (j * pt + koff)[None, None, :] <= qp[b][:, :, None]
            sk = k_scale[pid] if quant else None
            sv = v_scale[pid] if quant else None
            m, l, acc = _page_update(qt[b], pages_k[pid], pages_v[pid],
                                     valid[:, None], m, l, acc, scale, sk, sv)
        ctx = (acc / torch.clamp_min(l, 1e-30)[..., None]).to(dtype)
        out.append(ctx.permute(0, 2, 1, 3).reshape(nt * _QTILE, nh, hd)[:C])
    return torch.stack(out)


def split_plan(pt, mp):
    """How the kernel cuts a lane's ``mp`` pages of ``pt`` tokens across
    blocks: ``(pages per split, number of splits)``. A split is as many
    whole pages as fit in ``_SPLIT_KEYS`` keys (at least one), so its
    boundaries are fixed key positions that depend on ``pt`` alone: a
    wider table only appends splits, and neither the batch nor the chunk
    width moves a boundary. A query's bits rest on that."""
    pps = max(1, _SPLIT_KEYS // pt)
    return pps, -(-mp // pps)


def split_bounds(pt, mp):
    """The ``[start, end)`` key positions of every split of ``split_plan``."""
    pps, nsplit = split_plan(pt, mp)
    return [(s * pps * pt, min((s + 1) * pps, mp) * pt) for s in range(nsplit)]


def _scratch_shapes(B, C, nh, hd, nsplit):
    """Shapes of the fp32 scratch for the splits' partials: the
    accumulators and the (m, l) pairs, one row per (split, query, head)."""
    return (nsplit, B, C, nh, hd), (nsplit, B, C, nh, 2)


def _merge_partial(carry, part):
    """The kernel's merge of two online-softmax carries ``(m, l, acc)``
    (m, l [...]; acc [..., hd]; fp32): every product and sum rounded on
    its own. A part that saw no key (m = -1e30, l = 0, acc = 0) changes
    nothing, bit for bit."""
    (m1, l1, a1), (m2, l2, a2) = carry, part
    m = torch.maximum(m1, m2)
    w1, w2 = torch.exp(m1 - m), torch.exp(m2 - m)
    return m, l1 * w1 + l2 * w2, a1 * w1[..., None] + a2 * w2[..., None]


def _decode_attend_cuda(q, pages_k, pages_v, tables, qpos, pt, dtype,
                        k_scale, v_scale, prefill=False):
    B, C, nh, hd = q.shape
    P = pages_k.shape[0]
    mp = tables.shape[1]
    dev = q.device
    quant = k_scale is not None
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"decode_attend: query dtype {q.dtype} not supported "
                         "(float32 or bfloat16)")
    if dtype != q.dtype:
        raise ValueError(f"decode_attend: output dtype {dtype} must equal the "
                         f"query dtype {q.dtype}")
    if pages_k.dtype not in (q.dtype, torch.bfloat16, torch.int8):
        raise ValueError(f"decode_attend: page dtype {pages_k.dtype} not "
                         f"supported with {q.dtype} queries")
    if pages_v.dtype != pages_k.dtype:
        raise ValueError("decode_attend: pages_k and pages_v dtypes differ")
    if quant != (pages_k.dtype == torch.int8):
        raise ValueError("decode_attend: int8 pages need k_scale/v_scale, "
                         "and only int8 pages take them")
    if hd not in (64, 128):
        raise ValueError(f"decode_attend: head dim {hd} not supported (64, 128)")
    if not 1 <= pt <= 256:
        raise ValueError(f"decode_attend: page size {pt} not in [1, 256]")
    if pages_k.shape != (P, nh, pt, hd) or pages_v.shape != (P, nh, pt, hd):
        raise ValueError(f"decode_attend: pages {tuple(pages_k.shape)} / "
                         f"{tuple(pages_v.shape)} do not match {(P, nh, pt, hd)}")
    if tables.shape[0] != B or qpos.shape != (B, C):
        raise ValueError("decode_attend: tables/qpos shapes do not match q")
    tensors = [q, pages_k, pages_v, tables, qpos]
    if quant:
        tensors += [k_scale, v_scale]
        if k_scale.shape != (P, nh) or v_scale.shape != (P, nh):
            raise ValueError("decode_attend: scales must be [P, nh]")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"decode_attend: tensor on {t.device}, query on {dev}")
        if not t.is_contiguous():
            raise ValueError("decode_attend: every input must be contiguous")
    out = torch.empty_like(q)
    pps, nsplit = split_plan(pt, mp)
    acc_shape, ml_shape = _scratch_shapes(B, C, nh, hd, nsplit)
    n_acc = math.prod(acc_shape)
    scratch = torch.empty(n_acc + math.prod(ml_shape), dtype=torch.float32, device=dev)
    part_acc, part_ml = scratch[:n_acc], scratch[n_acc:]
    lib = build.load_library()
    with torch.cuda.device(dev):
        rc = lib.ds_decode_attend(
            q.data_ptr(), pages_k.data_ptr(), pages_v.data_ptr(),
            tables.data_ptr(), qpos.data_ptr(),
            k_scale.data_ptr() if quant else None,
            v_scale.data_ptr() if quant else None,
            out.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(),
            B, C, nh, hd, pt, mp, pps, _DTYPE_CODES[q.dtype],
            _DTYPE_CODES[pages_k.dtype], int(bool(prefill)),
            float(_attn_scale(hd, dtype, quant)),
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, "decode_attention")
    registry.record_launch("decode_attention")
    return out


def decode_attend(q, pages_k, pages_v, tables, qpos, *, page_tokens, dtype,
                  k_scale=None, v_scale=None, prefill=False):
    """Paged fused attention: q [B, C, nh, hd] at positions qpos [B, C]
    over the page pool pages_k/v [P, nh, pt, hd] through per-lane page
    tables [B, mp]. int8 pools pass ``k_scale``/``v_scale`` ([P, nh, 1, 1]
    or [P, nh] f32, per page and head); bf16 pages cast at load. Returns
    [B, C, nh, hd] in ``dtype``. ``prefill`` says the queries are a
    prompt's chunk and not a decode step; the kernel picks its routine by
    it (the plain version has one routine). CUDA tensors launch the kernel,
    CPU tensors run the plain version."""
    pt = int(page_tokens)
    if pages_k.shape[2] != pt:
        raise ValueError(f"pool page size {pages_k.shape[2]} != page_tokens {pt}")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be passed together")
    q = q.contiguous()
    tables = tables.to(torch.int32).contiguous()
    qpos = qpos.to(torch.int32).contiguous()
    if k_scale is not None:
        P, nh = pages_k.shape[0], pages_k.shape[1]
        k_scale = k_scale.to(torch.float32).reshape(P, nh).contiguous()
        v_scale = v_scale.to(torch.float32).reshape(P, nh).contiguous()
    if q.device.type == "cpu":
        return _decode_attend_torch(q, pages_k, pages_v, tables, qpos, pt,
                                    dtype, k_scale, v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attend: no kernel for device {q.device}")
    return _decode_attend_cuda(q, pages_k, pages_v, tables, qpos, pt, dtype,
                               k_scale, v_scale, prefill)


def chunk_attend(q, cache_k, cache_v, qpos, page_tokens, dtype, prefill=False):
    """Contiguous-cache adapter: caches [B, nh, S, hd] (S a multiple of
    ``page_tokens``) are viewed as per-lane page runs with an identity
    page table and routed through ``decode_attend`` (``prefill`` as
    there), so the contiguous path and the serving pool run the same
    kernel."""
    B, C, nh, hd = q.shape
    S = cache_k.shape[2]
    pt = int(page_tokens)
    if S % pt:
        raise ValueError(f"cache length {S} is not a multiple of page {pt}")
    mp = S // pt

    def paged(cache):
        blocks = cache.reshape(B, nh, mp, pt, hd).transpose(1, 2)
        return blocks.reshape(B * mp, nh, pt, hd).contiguous()

    tables = torch.arange(B * mp, dtype=torch.int32,
                          device=q.device).reshape(B, mp)
    return decode_attend(q, paged(cache_k), paged(cache_v), tables, qpos,
                         page_tokens=pt, dtype=dtype, prefill=prefill)
