"""Fused (optionally block-sparse) flash attention with in-kernel dropout:
the CUDA kernels ``csrc/flash_attention.cu`` and their plain PyTorch
versions.

Port of ``deepspeed_tpu/ops/transformer/attention.py``. Three kernels,
one per Pallas kernel of the JAX module:

- ``flash_fwd`` (``_attn_kernel``): per (batch*head, query block), walk
  the row LUT of key blocks with an online softmax; returns ``out`` and
  the log-sum-exp ``lse`` (1e30 for rows that saw no key);
- ``flash_bwd_dq`` (``_attn_bwd_dq_kernel``): dq over the row LUT,
  recomputing p = exp(s - lse);
- ``flash_bwd_dkv`` (``_attn_bwd_dkv_kernel``): dk, dv and the key-bias
  gradient over the transposed LUT, one key block per program, so no
  atomics are needed.

Each wrapper launches its kernel for CUDA tensors and runs its plain
version (``_flash_*_torch``) for CPU tensors; nothing falls back from one
to the other. The plain versions walk the same LUTs block by block with
the same fp32 arithmetic and the same rounding points as the JAX kernels
(matmul operands in the input dtype, products accumulated in fp32,
probabilities and ds rounded to the input dtype before their products).

Dropout on the softmax probabilities is regenerated, not stored: every
(query block, key block) tile draws its keep mask from Philox4x32-10 with
key (seed, batch*head) and counter (query block, key block, row,
column / 4), one call giving four columns. A probability is kept when its
32-bit word is >= floor(rate * 2**32) and then scaled by 1 / (1 - rate).
The forward and both backward kernels, and the plain versions, draw the
identical mask. The bits differ from the TPU kernel's PRNG by design.
"""

import numpy as np
import torch

from deepspeed_tpu_torch.kernels import build, registry

DEFAULT_BLOCK = 128
_NEG = -1e30
_BIG = 1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 3}
_KERNEL_BLOCKS = (16, 32, 64, 128)
_KERNEL_HEAD_DIMS = (32, 64, 128)


# ---------------------------------------------------------------------------
# layout -> LUT (numpy, as the JAX package's host_ops fallback)
# ---------------------------------------------------------------------------

def _dense_lut(num_heads, num_q_blocks, num_k_blocks):
    lut = np.tile(np.arange(num_k_blocks, dtype=np.int32), (num_heads, num_q_blocks, 1))
    counts = np.full((num_heads, num_q_blocks), num_k_blocks, np.int32)
    return lut, counts


def layout_to_lut(layout):
    """[H, Qb, Kb] 0/1 layout -> (lut [H, Qb, maxnnz] int32, counts [H, Qb]).

    Rows are padded to the largest row population (at least 1); the
    kernels loop ``counts`` blocks, so the padding is never read."""
    layout = np.ascontiguousarray(layout, np.int64)
    H, Qb, _ = layout.shape
    counts = layout.sum(-1).astype(np.int32)
    maxn = max(int(counts.max()), 1)
    lut = np.zeros((H, Qb, maxn), np.int32)
    for h in range(H):
        for q in range(Qb):
            idx = np.nonzero(layout[h, q])[0]
            lut[h, q, :len(idx)] = idx
    return lut, counts


def _luts_for(layout, H, S, block):
    """(row LUT, counts, transposed LUT, transposed counts), numpy."""
    nb = S // block
    if layout is None:
        lut, counts = _dense_lut(H, nb, nb)
        return lut, counts, lut, counts
    layout = np.asarray(layout)
    lut, counts = layout_to_lut(layout)
    qlut, qcounts = layout_to_lut(layout.transpose(0, 2, 1))
    return lut, counts, qlut, qcounts


_DEVICE_LUTS = {}


def _device_luts(layout, H, S, block, device):
    """``_luts_for`` as int32 tensors on ``device``, cached per layout, so
    a training step copies no LUT to the card."""
    arr = None if layout is None else np.ascontiguousarray(layout, np.int64)
    key = (None if arr is None else (arr.shape, arr.tobytes()), H, S, block, str(device))
    if key not in _DEVICE_LUTS:
        _DEVICE_LUTS[key] = tuple(torch.from_numpy(np.ascontiguousarray(t)).to(device)
                                  for t in _luts_for(arr, H, S, block))
    return _DEVICE_LUTS[key]


def _expand_layout_mask(layout, S, block):
    if layout is None:
        return None
    lay = torch.as_tensor(np.asarray(layout)).bool()
    return lay.repeat_interleave(block, dim=1).repeat_interleave(block, dim=2)[:, :S, :S]


# ---------------------------------------------------------------------------
# Philox4x32-10 in int64 arithmetic (bit-identical to the kernels' device
# function; Salmon et al., "Parallel random numbers: as easy as 1, 2, 3")
# ---------------------------------------------------------------------------

_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
_U32 = 0xFFFFFFFF


def _mulhilo(a, b):
    """(hi, lo) 32-bit words of the 64-bit product of the constant ``a``
    and ``b`` (int64 tensor holding uint32 values), without overflowing
    int64: ``b`` is split into 16-bit halves."""
    t_lo = a * (b & 0xFFFF)                      # < 2**48
    t_hi = a * (b >> 16)                         # < 2**48
    mid = t_lo + ((t_hi & 0xFFFF) << 16)         # < 2**49
    return (t_hi >> 16) + (mid >> 32), mid & _U32


def philox4x32(counter, key):
    """Philox4x32-10 of ``counter`` (four uint32 words) under ``key`` (two
    words). Words are ints or int64 tensors that broadcast together;
    returns the four output words as int64 tensors."""
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64) for c in counter)
    k0, k1 = (torch.as_tensor(k, dtype=torch.int64) for k in key)
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W0) & _U32
            k1 = (k1 + _PHILOX_W1) & _U32
        hi0, lo0 = _mulhilo(_PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(_PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _dropout_threshold(rate):
    return min(int(rate * 2**32), 2**32 - 1)


def _keep_scale(rate):
    """1 / (1 - rate) as the fp32 the kernels multiply by."""
    return float(np.float32(1.0 / (1.0 - rate)))


def _dropout_keep(seed, bh, qi, kj, block_q, block_k, rate, device):
    """[..., block_q, block_k] fp32 keep multipliers (0 or 1/(1-rate)) of
    the tile (qi, kj) for programs ``bh``. ``bh``, ``qi`` and ``kj`` are
    int64 tensors broadcasting to the leading dims (or ints)."""
    as_t = lambda x: torch.as_tensor(x, dtype=torch.int64, device=device)[..., None, None]
    row = torch.arange(block_q, device=device)[:, None]
    col4 = torch.arange(block_k // 4, device=device)[None, :]
    words = philox4x32((as_t(qi), as_t(kj), row, col4), (int(seed), as_t(bh)))
    bits = torch.stack(torch.broadcast_tensors(*words), dim=-1)
    bits = bits.reshape(*bits.shape[:-2], block_k)
    keep = bits >= _dropout_threshold(rate)
    return torch.where(keep, torch.tensor(_keep_scale(rate), device=device),
                       torch.tensor(0.0, device=device))


def _dropout_keep_dense(seed, B, H, S, block, rate, device):
    """The kernels' keep multipliers as a dense [B, H, S, S] tensor (the
    composed reference path); positions past S of a ragged last block
    are drawn and cropped."""
    nb = -(-S // block)
    bh = torch.arange(B * H, device=device).reshape(B, H, 1, 1)
    qi = torch.arange(nb, device=device).reshape(1, 1, nb, 1)
    kj = torch.arange(nb, device=device).reshape(1, 1, 1, nb)
    keep = _dropout_keep(seed, bh, qi, kj, block, block, rate, device)  # [B,H,nb,nb,bq,bk]
    keep = keep.permute(0, 1, 2, 4, 3, 5).reshape(B, H, nb * block, nb * block)
    return keep[:, :, :S, :S]


# ---------------------------------------------------------------------------
# plain PyTorch versions of the three kernels
# ---------------------------------------------------------------------------

def _in_dtype_dot(a, b, dtype):
    """a @ b with operands rounded to ``dtype`` and fp32 accumulation (the
    kernels' and the MXU's discipline: products of bf16 values are exact
    in fp32)."""
    return torch.matmul(a.to(dtype).float(), b.to(dtype).float())


def _gather_blocks(x, idx, block):
    """x [B, H, S, ...] -> block ``idx[h]`` of every head: [B, H, block, ...]."""
    B, H, S = x.shape[:3]
    xb = x.reshape(B, H, S // block, block, *x.shape[3:])
    return xb[:, torch.arange(H, device=x.device), idx]


def _masked_scores(qf, kf, bias_blk, scale, causal, qi, kj, block):
    """s = (q k^T) * scale + bias with the causal -1e30 sentinel; qf/kf
    fp32 [B, H, block, D], bias_blk [B, H, block]; qi/kj [H] tensors."""
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    s = s + bias_blk[:, :, None, :]
    if causal:
        dev = qf.device
        ar = torch.arange(block, device=dev)
        q_pos = qi.reshape(-1, 1, 1) * block + ar[:, None]
        k_pos = kj.reshape(-1, 1, 1) * block + ar[None, :]
        s = torch.where(q_pos >= k_pos, s, _NEG)
    return s


def _flash_fwd_torch(q, k, v, bias, lut, counts, block, causal, rate, seed):
    B, H, S, D = q.shape
    dev, dtype = q.device, q.dtype
    scale = 1.0 / float(np.sqrt(D))
    lut, counts = lut.long(), counts.long()
    bias32 = bias.float()[:, None, :].expand(B, H, S)
    bh = torch.arange(B * H, device=dev).reshape(B, H)
    out = torch.empty_like(q)
    lse = torch.empty(B, H, S, dtype=torch.float32, device=dev)
    for qi in range(S // block):
        rows = slice(qi * block, (qi + 1) * block)
        qf = q[:, :, rows].float()
        qi_h = torch.full((H,), qi, dtype=torch.long, device=dev)
        m = torch.full((B, H, block, 1), _NEG, device=dev)
        l = torch.zeros(B, H, block, 1, device=dev)
        acc = torch.zeros(B, H, block, D, device=dev)
        for n in range(lut.shape[-1]):
            active = (n < counts[:, qi]).reshape(1, H, 1, 1)
            if not bool(active.any()):
                break
            kj = lut[:, qi, n]
            kf = _gather_blocks(k, kj, block).float()
            vb = _gather_blocks(v, kj, block)
            s = _masked_scores(qf, kf, _gather_blocks(bias32, kj, block), scale,
                               causal, qi_h, kj, block)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp(s - m_new)
            corr = torch.exp(m - m_new)
            l_new = l * corr + p.sum(-1, keepdim=True)
            p_acc = p
            if rate > 0.0:
                p_acc = p * _dropout_keep(seed, bh, qi, kj[None, :], block, block, rate, dev)
            acc_new = acc * corr + _in_dtype_dot(p_acc, vb, dtype)
            m = torch.where(active, m_new, m)
            l = torch.where(active, l_new, l)
            acc = torch.where(active, acc_new, acc)
        alive = l > 0.0
        safe_l = torch.where(alive, l, 1.0)
        out[:, :, rows] = torch.where(alive, acc / safe_l, 0.0).to(out.dtype)
        lse[:, :, rows] = torch.where(alive, m + torch.log(safe_l), _BIG)[..., 0]
    return out, lse.reshape(B * H, S)


def _flash_bwd_dq_torch(q, k, v, bias, do, lse, delta, lut, counts, block, causal,
                        rate, seed):
    B, H, S, D = q.shape
    dev, dtype = q.device, q.dtype
    scale = 1.0 / float(np.sqrt(D))
    lut, counts = lut.long(), counts.long()
    bias32 = bias.float()[:, None, :].expand(B, H, S)
    lse = lse.reshape(B, H, S)
    delta = delta.reshape(B, H, S)
    bh = torch.arange(B * H, device=dev).reshape(B, H)
    dq = torch.empty_like(q)
    for qi in range(S // block):
        rows = slice(qi * block, (qi + 1) * block)
        qf = q[:, :, rows].float()
        dof = do[:, :, rows].float()
        lse_i = lse[:, :, rows, None]
        delta_i = delta[:, :, rows, None]
        qi_h = torch.full((H,), qi, dtype=torch.long, device=dev)
        acc = torch.zeros(B, H, block, D, device=dev)
        for n in range(lut.shape[-1]):
            active = (n < counts[:, qi]).reshape(1, H, 1, 1)
            if not bool(active.any()):
                break
            kj = lut[:, qi, n]
            kb = _gather_blocks(k, kj, block)
            vf = _gather_blocks(v, kj, block).float()
            s = _masked_scores(qf, kb.float(), _gather_blocks(bias32, kj, block), scale,
                               causal, qi_h, kj, block)
            p = torch.exp(s - lse_i)
            dp = torch.matmul(dof, vf.transpose(-1, -2))
            if rate > 0.0:
                dp = dp * _dropout_keep(seed, bh, qi, kj[None, :], block, block, rate, dev)
            ds = p * (dp - delta_i)
            acc = acc + torch.where(active, _in_dtype_dot(ds, kb, dtype), 0.0)
        dq[:, :, rows] = (acc * scale).to(dq.dtype)
    return dq


def _flash_bwd_dkv_torch(q, k, v, bias, do, lse, delta, qlut, qcounts, block, causal,
                         rate, seed):
    B, H, S, D = q.shape
    dev, dtype = q.device, q.dtype
    scale = 1.0 / float(np.sqrt(D))
    qlut, qcounts = qlut.long(), qcounts.long()
    lse = lse.reshape(B, H, S)
    delta = delta.reshape(B, H, S)
    bh = torch.arange(B * H, device=dev).reshape(B, H)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    db = torch.empty(B, H, S, dtype=torch.float32, device=dev)
    for kj in range(S // block):
        cols = slice(kj * block, (kj + 1) * block)
        kf = k[:, :, cols].float()
        vf = v[:, :, cols].float()
        bias_j = bias.float()[:, None, cols].expand(B, H, block)
        kj_h = torch.full((H,), kj, dtype=torch.long, device=dev)
        dk_acc = torch.zeros(B, H, block, D, device=dev)
        dv_acc = torch.zeros(B, H, block, D, device=dev)
        db_acc = torch.zeros(B, H, block, device=dev)
        for n in range(qlut.shape[-1]):
            active = (n < qcounts[:, kj]).reshape(1, H, 1, 1)
            if not bool(active.any()):
                break
            qi = qlut[:, kj, n]
            qb = _gather_blocks(q, qi, block)
            dob = _gather_blocks(do, qi, block)
            lse_i = _gather_blocks(lse, qi, block)[..., None]
            delta_i = _gather_blocks(delta, qi, block)[..., None]
            s = _masked_scores(qb.float(), kf, bias_j, scale, causal, qi, kj_h, block)
            p = torch.exp(s - lse_i)
            dp = torch.matmul(dob.float(), vf.transpose(-1, -2))
            p_drop = p
            if rate > 0.0:
                keep = _dropout_keep(seed, bh, qi[None, :], kj, block, block, rate, dev)
                p_drop = p * keep
                dp = dp * keep
            ds = p * (dp - delta_i)
            dv_acc = dv_acc + torch.where(
                active, _in_dtype_dot(p_drop.transpose(-1, -2), dob, dtype), 0.0)
            dk_acc = dk_acc + torch.where(
                active, _in_dtype_dot(ds.transpose(-1, -2), qb, dtype), 0.0)
            db_acc = db_acc + torch.where(active[..., 0], ds.sum(-2), 0.0)
        dk[:, :, cols] = (dk_acc * scale).to(dk.dtype)
        dv[:, :, cols] = dv_acc.to(dv.dtype)
        db[:, :, cols] = db_acc
    return dk, dv, db.reshape(B * H, S)


# ---------------------------------------------------------------------------
# kernel wrappers: CUDA tensors launch the kernel, CPU tensors run the plain
# version
# ---------------------------------------------------------------------------

def _check_cuda_inputs(name, q, k, v, bias, block, extra=()):
    B, H, S, D = q.shape
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: dtype {q.dtype} not supported "
                         "(float32, bfloat16 or float16)")
    if D not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"{name}: head dim {D} not supported {_KERNEL_HEAD_DIMS}")
    if block not in _KERNEL_BLOCKS or S % block:
        raise ValueError(f"{name}: block {block} not supported {_KERNEL_BLOCKS} "
                         f"or does not divide S={S}")
    for t in (k, v, *extra):
        if tuple(t.shape) != (B, H, S, D) or t.dtype != q.dtype:
            raise ValueError(f"{name}: operand {tuple(t.shape)} {t.dtype} does not "
                             f"match q {tuple(q.shape)} {q.dtype}")
    if tuple(bias.shape) != (B, S) or bias.dtype != torch.float32:
        raise ValueError(f"{name}: bias must be float32 [B, S]")
    for t in (q, k, v, bias, *extra):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name}: every operand must be contiguous on {q.device}")


def _dropout_args(rate, seed):
    if rate > 0.0:
        return int(seed), _dropout_threshold(rate), _keep_scale(rate), 1
    return 0, 0, 1.0, 0


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def flash_fwd(q, k, v, bias, lut, counts, *, block, causal, rate=0.0, seed=0):
    """Kernel 1. q/k/v [B, H, S, D] contiguous, bias fp32 [B, S], lut
    int32 [H, S/block, maxn], counts int32 [H, S/block] -> (out [B, H, S,
    D] in q's dtype, lse fp32 [B*H, S])."""
    if q.device.type == "cpu":
        return _flash_fwd_torch(q, k, v, bias, lut, counts, block, causal, rate, seed)
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd: no kernel for device {q.device}")
    _check_cuda_inputs("flash_fwd", q, k, v, bias, block)
    B, H, S, D = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(B * H, S, dtype=torch.float32, device=q.device)
    lib = build.load_library()
    with torch.cuda.device(q.device):
        rc = lib.ds_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), lut.data_ptr(),
            counts.data_ptr(), out.data_ptr(), lse.data_ptr(),
            B, H, S, D, block, lut.shape[-1], int(causal), _DTYPE_CODES[q.dtype],
            1.0 / float(np.sqrt(D)), *_dropout_args(rate, seed), _stream(q.device))
    build.check(rc, "flash_attention_fwd")
    registry.record_launch("flash_attention_fwd")
    return out, lse


def flash_bwd_dq(q, k, v, bias, do, lse, delta, lut, counts, *, block, causal,
                 rate=0.0, seed=0):
    """Kernel 2: dq [B, H, S, D] from dO, the forward's lse and
    delta = rowsum(dO * out) (both fp32 [B*H, S])."""
    if q.device.type == "cpu":
        return _flash_bwd_dq_torch(q, k, v, bias, do, lse, delta, lut, counts, block,
                                   causal, rate, seed)
    if q.device.type != "cuda":
        raise ValueError(f"flash_bwd_dq: no kernel for device {q.device}")
    _check_cuda_inputs("flash_bwd_dq", q, k, v, bias, block, extra=(do,))
    B, H, S, D = q.shape
    dq = torch.empty_like(q)
    lib = build.load_library()
    with torch.cuda.device(q.device):
        rc = lib.ds_flash_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), lut.data_ptr(), counts.data_ptr(),
            dq.data_ptr(), B, H, S, D, block, lut.shape[-1], int(causal),
            _DTYPE_CODES[q.dtype], 1.0 / float(np.sqrt(D)), *_dropout_args(rate, seed),
            _stream(q.device))
    build.check(rc, "flash_attention_bwd_dq")
    registry.record_launch("flash_attention_bwd_dq")
    return dq


def flash_bwd_dkv(q, k, v, bias, do, lse, delta, qlut, qcounts, *, block, causal,
                  rate=0.0, seed=0):
    """Kernel 3: (dk, dv [B, H, S, D], db fp32 [B*H, S]) over the
    transposed LUT."""
    if q.device.type == "cpu":
        return _flash_bwd_dkv_torch(q, k, v, bias, do, lse, delta, qlut, qcounts, block,
                                    causal, rate, seed)
    if q.device.type != "cuda":
        raise ValueError(f"flash_bwd_dkv: no kernel for device {q.device}")
    _check_cuda_inputs("flash_bwd_dkv", q, k, v, bias, block, extra=(do,))
    B, H, S, D = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    db = torch.empty(B * H, S, dtype=torch.float32, device=q.device)
    lib = build.load_library()
    with torch.cuda.device(q.device):
        rc = lib.ds_flash_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), qlut.data_ptr(), qcounts.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), db.data_ptr(), B, H, S, D, block,
            qlut.shape[-1], int(causal), _DTYPE_CODES[q.dtype], 1.0 / float(np.sqrt(D)),
            *_dropout_args(rate, seed), _stream(q.device))
    build.check(rc, "flash_attention_bwd_dkv")
    registry.record_launch("flash_attention_bwd_dkv")
    return dk, dv, db


def attention_forward(q, k, v, bias, lut, counts, *, block, causal, rate=0.0, seed=0):
    """The counterpart of the JAX ``_attention_pallas``: q/k/v [B, H, S,
    D], key bias [B, S] -> (out, lse [B*H, S])."""
    q, k, v = (t.contiguous() for t in (q, k, v))
    return flash_fwd(q, k, v, bias.float().contiguous(), lut, counts, block=block,
                     causal=causal, rate=rate, seed=seed)


def attention_backward(q, k, v, bias, out, lse, g, lut, counts, qlut, qcounts, *, block,
                       causal, rate=0.0, seed=0):
    """The counterpart of the JAX ``_attention_pallas_bwd``: returns (dq,
    dk, dv, dbias [B, S] in the bias dtype)."""
    B, H, S, D = q.shape
    q, k, v, g = (t.contiguous() for t in (q, k, v, g))
    bias32 = bias.float().contiguous()
    delta = (g.float() * out.float()).sum(-1).reshape(B * H, S)
    kw = dict(block=block, causal=causal, rate=rate, seed=seed)
    dq = flash_bwd_dq(q, k, v, bias32, g, lse, delta, lut, counts, **kw)
    dk, dv, db = flash_bwd_dkv(q, k, v, bias32, g, lse, delta, qlut, qcounts, **kw)
    dbias = db.reshape(B, H, S).sum(1).to(bias.dtype)
    return dq, dk, dv, dbias


# ---------------------------------------------------------------------------
# composed reference paths (the JAX package's non-kernel path)
# ---------------------------------------------------------------------------

def _attention_reference(q, k, v, bias, layout_mask, *, causal, dropout_rate=0.0,
                         seed=None, block=DEFAULT_BLOCK):
    """Dense masked attention in fp32 with autograd; ``layout_mask`` [H,
    S, S] bool or None. Dropout (with a seed) multiplies the probabilities
    by the kernels' own Philox keep mask, so this path and the kernels
    draw the same mask."""
    B, H, S, D = q.shape
    scale = 1.0 / np.sqrt(D)
    s = torch.einsum("bhsd,bhtd->bhst", q.float(), k.float()) * scale
    s = s + bias[:, None, None, :].float()
    if causal:
        cm = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        s = torch.where(cm, s, _NEG)
    if layout_mask is not None:
        s = torch.where(layout_mask.to(q.device)[None], s, _NEG)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    alive = m > -1e29
    probs = torch.where(alive, p / torch.where(l > 0, l, 1.0), 0.0)
    if dropout_rate > 0.0 and seed is not None:
        probs = probs * _dropout_keep_dense(seed, B, H, S, block, dropout_rate, q.device)
    out = torch.einsum("bhst,bhtd->bhsd", probs, v.float())
    return out.to(q.dtype)


def attention_reference(q, k, v, mask=None, causal=False):
    """Dense attention with an arbitrary ADDITIVE mask broadcastable to
    [B, H, S, S]: the path for masks ``flash_attention`` cannot express
    as a key bias."""
    S, D = q.shape[2], q.shape[3]
    s = torch.einsum("bhsd,bhtd->bhst", q.float(), k.float()) * (1.0 / np.sqrt(D))
    if mask is not None:
        m = torch.as_tensor(mask, dtype=torch.float32, device=q.device)
        if m.ndim == 2:
            m = m[:, None, None, :]
        s = s + m
    if causal:
        cm = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        s = torch.where(cm, s, _NEG)
    probs = torch.softmax(s, dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", probs, v.float()).to(q.dtype)


# ---------------------------------------------------------------------------
# autograd wiring and the public entry
# ---------------------------------------------------------------------------

class _FlashAttention(torch.autograd.Function):
    """Kernel 1 forward; kernels 2 and 3 backward. Saves out, lse and the
    dropout seed, never the probabilities or the mask."""

    @staticmethod
    def forward(ctx, q, k, v, bias, layout, block, causal, rate, seed):
        B, H, S, D = q.shape
        q, k, v = (t.contiguous() for t in (q, k, v))
        luts = _device_luts(layout, H, S, block, q.device)
        out, lse = attention_forward(q, k, v, bias, luts[0], luts[1], block=block,
                                     causal=causal, rate=rate, seed=seed)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.luts = luts
        ctx.config = dict(block=block, causal=causal, rate=rate, seed=seed)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, out, lse = ctx.saved_tensors
        dq, dk, dv, dbias = attention_backward(q, k, v, bias, out, lse, g, *ctx.luts,
                                               **ctx.config)
        return (dq, dk, dv, dbias if ctx.needs_input_grad[3] else None,
                None, None, None, None, None)


def draw_dropout_seed(generator):
    """One int32 dropout seed from ``generator`` (as the JAX package draws
    one from its PRNG key)."""
    return int(torch.randint(0, 2**31 - 1, (1,), generator=generator,
                             device=generator.device))


def flash_attention(q, k, v, mask=None, layout=None, block=DEFAULT_BLOCK, causal=False,
                    force_reference=False, dropout_rate=0.0, generator=None):
    """Fused attention. q, k, v: [B, H, S, D]; ``mask``: additive key bias
    [B, 1, 1, S] or [B, S]; ``layout``: optional [H, S/block, S/block] 0/1
    block sparsity; ``causal`` adds the autoregressive mask in-kernel.

    ``dropout_rate`` > 0 (with a ``torch.Generator``) drops softmax
    probabilities inside the kernels; the mask is regenerated from one
    seed in the backward kernels instead of being stored. A sequence that
    ``block`` does not divide runs the dense composed path."""
    B, H, S, D = q.shape
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got {dropout_rate} "
                         "(a fraction, not a percentage)")
    if dropout_rate > 0.0:
        if generator is None:
            raise ValueError("dropout_rate > 0 requires a generator")
        seed = draw_dropout_seed(generator)
    else:
        seed, dropout_rate = None, 0.0
    if S % block != 0:
        force_reference = True
    if mask is None:
        bias = torch.zeros(B, S, dtype=q.dtype, device=q.device)
    elif mask.ndim == 4:
        # only a broadcastable key bias [B,1,1,S] collapses losslessly; a
        # full [B,1,S,S]/[B,H,S,S] mask must not be cut to its first row
        if mask.shape[-2] != 1 or mask.shape[1] != 1:
            raise ValueError(
                f"flash_attention only supports key-bias masks [B,1,1,S] or [B,S]; "
                f"got {tuple(mask.shape)}. For causal masking pass causal=True; for an "
                f"arbitrary S x S additive mask use attention_reference.")
        bias = mask[:, 0, 0, :]
    else:
        bias = mask
    if force_reference:
        return _attention_reference(q, k, v, bias, _expand_layout_mask(layout, S, block),
                                    causal=causal, dropout_rate=dropout_rate, seed=seed,
                                    block=block)
    return _FlashAttention.apply(q, k, v, bias, layout, block, causal,
                                 float(dropout_rate), 0 if seed is None else seed)
