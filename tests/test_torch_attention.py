"""The port's flash attention, held against the JAX package's on the CPU.

On the CPU each kernel wrapper of
``deepspeed_tpu_torch.ops.transformer.attention`` runs its kernel's plain
PyTorch version; ``chip_smoke.py`` holds the CUDA kernels against those
plain versions on the card. Here the plain versions meet the JAX package
as its own tests drive it: the Pallas kernels in interpret mode
(``_attention_pallas`` / ``_attention_pallas_bwd``), the composed
reference paths, and ``flash_attention``'s gradients. Inputs come from
numpy seeds and go to both packages.

Tolerances: fp32 1e-5 (the same fp32 math summed in another order);
bf16 2e-2 of the compared tensor's largest magnitude (probabilities and
ds are rounded to bf16 at the same points on both sides, but a different
summation order can flip a rounding); fp16 2e-3 for the same reason,
about two fp16 steps (2**-10) at the largest magnitude where bf16's 2e-2
is under three of its own (2**-7). With dropout on, the port's bits
(Philox4x32-10) differ from the TPU kernel's by design, so dropout is
checked statistically and against an explicit-mask reference.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from deepspeed_tpu.ops.transformer import attention as J  # noqa: E402
from deepspeed_tpu_torch.ops.transformer import attention as T  # noqa: E402

TOL = {"fp32": 1e-5, "bf16": 2e-2, "fp16": 2e-3}
DTYPES = {"fp32": (np.float32, jnp.float32, torch.float32),
          "bf16": (np.float32, jnp.bfloat16, torch.bfloat16),
          "fp16": (np.float32, jnp.float16, torch.float16)}


def _close(got, want, tol):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(x)).to(dtype)


def _case(seed, B, H, S, D, block, masked, causal, sparse):
    rng = np.random.RandomState(seed)
    q, k, v, g = (rng.randn(B, H, S, D).astype(np.float32) * 0.5 for _ in range(4))
    bias = np.zeros((B, S), np.float32)
    if masked:
        bias = np.where(rng.rand(B, S) < 0.25, -10000.0, 0.0).astype(np.float32)
    layout = None
    if sparse:
        nb = S // block
        layout = (rng.rand(H, nb, nb) < 0.5).astype(np.int64)
        layout[:, :, 0] = 1
        layout[0, 1, :] = 0          # an empty row: out 0, lse 1e30, no grads
    return q, k, v, g, bias, layout


CASES = {
    "dense": dict(masked=False, causal=False, sparse=False),
    "key_bias": dict(masked=True, causal=False, sparse=False),
    "causal": dict(masked=False, causal=True, sparse=False),
    "sparse_empty_row": dict(masked=False, causal=False, sparse=True),
    "causal_sparse_bias": dict(masked=True, causal=True, sparse=True),
}


@pytest.mark.parametrize("dtype", ["fp32", "bf16", "fp16"])
@pytest.mark.parametrize("block", [16, 32])
@pytest.mark.parametrize("name", list(CASES))
def test_kernels_match_pallas_interpret(name, block, dtype):
    B, H, S, D = 2, 2, 64, 16
    q, k, v, g, bias, layout = _case(7, B, H, S, D, block, **CASES[name])
    causal = CASES[name]["causal"]
    _, jdt, tdt = DTYPES[dtype]
    lut, counts, qlut, qcounts = T._luts_for(layout, H, S, block)
    jq, jk, jv, jg = (jnp.asarray(x, jdt) for x in (q, k, v, g))
    jb = jnp.asarray(bias)
    kw = dict(block_q=block, block_k=block, causal=causal, interpret=True)
    jout, jlse = J._attention_pallas(jq, jk, jv, jb, lut, counts, **kw)
    jgrads = J._attention_pallas_bwd(jq, jk, jv, jb, jout, jlse, jg, lut, counts, qlut,
                                     qcounts, **kw)

    tq, tk, tv, tg = (_t(x, tdt) for x in (q, k, v, g))
    luts = [torch.from_numpy(x) for x in (lut, counts, qlut, qcounts)]
    out, lse = T.attention_forward(tq, tk, tv, _t(bias), luts[0], luts[1], block=block,
                                   causal=causal)
    grads = T.attention_backward(tq, tk, tv, _t(bias), out, lse, tg, *luts, block=block,
                                 causal=causal)
    tol = TOL[dtype]
    _close(out.float().numpy(), np.asarray(jout, np.float32), tol)
    # lse is fp32 on both sides, whatever the input dtype
    alive = np.asarray(jlse) < 1e29
    np.testing.assert_array_equal(lse.numpy() < 1e29, alive)
    _close(lse.numpy()[alive], np.asarray(jlse)[alive], TOL["fp32"] if dtype == "fp32" else 1e-3)
    for got, want in zip(grads, jgrads):
        _close(got.float().numpy(), np.asarray(want, np.float32), tol)
    if layout is not None:   # head 0's query block 1 saw no key
        rows = slice(block, 2 * block)
        assert float(out[:, 0, rows].abs().max()) == 0.0
        assert float(grads[0][:, 0, rows].abs().max()) == 0.0
        assert (lse.reshape(B, H, S)[:, 0, rows] == 1e30).all()


@pytest.mark.parametrize("counter,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
])
def test_philox_known_answers(counter, key, want):
    """Random123's known-answer vectors for Philox4x32-10."""
    assert tuple(int(w) for w in T.philox4x32(counter, key)) == want


def test_layout_to_lut_matches_jax():
    rng = np.random.RandomState(3)
    layout = (rng.rand(3, 5, 5) < 0.4).astype(np.int64)
    layout[1, 2] = 0
    for lay in (layout, layout.transpose(0, 2, 1)):
        got_lut, got_counts = T.layout_to_lut(lay)
        want_lut, want_counts = J.layout_to_lut(lay)
        np.testing.assert_array_equal(got_counts, want_counts)
        for h in range(lay.shape[0]):
            for r in range(lay.shape[1]):
                n = got_counts[h, r]
                np.testing.assert_array_equal(got_lut[h, r, :n], want_lut[h, r, :n])
    np.testing.assert_array_equal(T._dense_lut(2, 3, 4)[0], J._dense_lut(2, 3, 4)[0])


@pytest.mark.parametrize("causal", [False, True])
def test_attention_references_match_jax(causal):
    B, H, S, D, block = 2, 2, 32, 8, 16
    q, k, v, _, bias, layout = _case(5, B, H, S, D, block, masked=True, causal=causal,
                                     sparse=True)
    jm = J._expand_layout_mask(layout, S, block)
    want = J._attention_reference(*(jnp.asarray(x) for x in (q, k, v, bias)), jm,
                                  causal=causal)
    got = T._attention_reference(_t(q), _t(k), _t(v), _t(bias),
                                 T._expand_layout_mask(layout, S, block), causal=causal)
    _close(got.numpy(), np.asarray(want), TOL["fp32"])
    full = np.random.RandomState(6).randn(B, 1, S, S).astype(np.float32)
    for mask in (full, bias):
        want = J.attention_reference(*(jnp.asarray(x) for x in (q, k, v)),
                                     jnp.asarray(mask), causal=causal)
        got = T.attention_reference(_t(q), _t(k), _t(v), _t(mask), causal=causal)
        _close(got.numpy(), np.asarray(want), TOL["fp32"])


@pytest.mark.parametrize("S,block", [(64, 32), (40, 16)])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_grads_match_jax(S, block, causal):
    """Through the autograd.Function (plain versions of kernels 1-3) when
    ``block`` divides S, else the dense composed path; JAX runs its
    reference path on the CPU."""
    B, H, D = 2, 2, 8
    q, k, v, g, bias, _ = _case(9, B, H, S, D, block, masked=True, causal=False,
                                sparse=False)
    mask = bias[:, None, None, :]

    def jloss(q, k, v, m):
        return jnp.sum(J.flash_attention(q, k, v, m, block=block, causal=causal) * g)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(*(jnp.asarray(x) for x in (q, k, v, mask)))
    ts = [_t(x).requires_grad_() for x in (q, k, v, mask)]
    out = T.flash_attention(*ts, block=block, causal=causal)
    (out * _t(g)).sum().backward()
    for t, w in zip(ts, want):
        _close(t.grad.numpy(), np.asarray(w), TOL["fp32"])


def test_bias_shape_errors_and_rate_checks():
    q = torch.zeros(1, 2, 32, 8)
    with pytest.raises(ValueError, match="key-bias"):
        T.flash_attention(q, q, q, torch.zeros(1, 1, 32, 32))
    with pytest.raises(ValueError, match="key-bias"):
        T.flash_attention(q, q, q, torch.zeros(1, 2, 1, 32))
    with pytest.raises(ValueError, match="dropout_rate"):
        T.flash_attention(q, q, q, dropout_rate=1.0, generator=torch.Generator())
    with pytest.raises(ValueError, match="generator"):
        T.flash_attention(q, q, q, dropout_rate=0.1)


def _rand_qkv(seed, B=1, H=2, S=64, D=16):
    rng = np.random.RandomState(seed)
    return [_t(rng.randn(B, H, S, D).astype(np.float32) * 0.3) for _ in range(3)]


def test_dropout_statistics_and_determinism():
    """Keep fraction ~ 1 - rate, the same mask for the same seed, another
    for another seed, and unbiased in expectation."""
    keep = T._dropout_keep_dense(11, 2, 2, 64, 16, 0.3, "cpu")
    frac = float((keep > 0).float().mean())
    assert abs(frac - 0.7) < 0.02, frac
    assert torch.all((keep == 0) | (keep == T._keep_scale(0.3)))
    q, k, v = _rand_qkv(11)
    run = lambda s: T.flash_attention(q, k, v, block=16, dropout_rate=0.3,
                                      generator=torch.Generator().manual_seed(s))
    torch.testing.assert_close(run(3), run(3), rtol=0, atol=0)
    assert float((run(3) - run(4)).abs().max()) > 0
    mean = torch.stack([run(100 + i) for i in range(24)]).mean(0)
    base = T.flash_attention(q, k, v, block=16)
    assert float((mean - base).abs().max()) < 0.25


@pytest.mark.parametrize("causal", [False, True])
def test_dropout_grads_match_explicit_mask_reference(causal):
    """Grads through kernels 1-3 (plain versions) at dropout 0.3 equal the
    grads of a composed implementation that multiplies in the same
    Philox mask: the backward regenerates the forward's mask exactly. The
    dense composed path draws that mask too, so both paths agree."""
    rate, block = 0.3, 16
    q, k, v = _rand_qkv(12)
    seed = T.draw_dropout_seed(torch.Generator().manual_seed(9))
    ts = [x.clone().requires_grad_() for x in (q, k, v)]
    out = T.flash_attention(*ts, block=block, causal=causal, dropout_rate=rate,
                            generator=torch.Generator().manual_seed(9))
    (out ** 2).sum().backward()

    rs = [x.clone().requires_grad_() for x in (q, k, v)]
    B, H, S, D = q.shape
    s = torch.einsum("bhsd,bhtd->bhst", rs[0], rs[1]) / np.sqrt(D)
    if causal:
        s = torch.where(torch.ones(S, S, dtype=torch.bool).tril(), s, -1e30)
    probs = torch.softmax(s, -1) * T._dropout_keep_dense(seed, B, H, S, block, rate, "cpu")
    ref = torch.einsum("bhst,bhtd->bhsd", probs, rs[2])
    (ref ** 2).sum().backward()
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    for a, b in zip(ts, rs):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-5, atol=1e-5)
    dense = T.flash_attention(q, k, v, block=block, causal=causal, dropout_rate=rate,
                              generator=torch.Generator().manual_seed(9),
                              force_reference=True)
    torch.testing.assert_close(dense, out.detach(), rtol=1e-5, atol=1e-5)


def _mma_tile_keep(seed, bh, qi, kj, warp, block, rate):
    """The bf16 forward kernel's keep mask of warp ``warp``'s 16 x
    ``block`` score tile, rebuilt from its lane map: in an mma accumulator
    lane t holds columns 8 nt + 2 (t % 4) + {0, 1} of the block's rows
    r0 = 16 warp + t / 4 and r0 + 8. A Philox call gives four neighbouring
    columns, so lanes t and t ^ 1 share a column quad: the even lane
    draws row r0's call, the odd lane row r0 + 8's, and each hands the
    other the two words of the other's columns. Returns bool [16, block]."""
    thr = T._dropout_threshold(rate)
    lane = torch.arange(32)
    odd = (lane & 1).bool()
    r0 = 16 * warp + (lane >> 2)
    keep = torch.zeros(16, block, dtype=torch.bool)
    for nt in range(block // 8):
        quad = 2 * nt + ((lane & 3) >> 1)
        x, y, z, w = T.philox4x32((qi, kj, torch.where(odd, r0 + 8, r0), quad), (seed, bh))
        send0, send1 = torch.where(odd, x, z), torch.where(odd, y, w)
        got0, got1 = send0[lane ^ 1], send1[lane ^ 1]       # __shfl_xor by 1
        words = (torch.where(odd, got0, x), torch.where(odd, got1, y),    # row r0
                 torch.where(odd, z, got0), torch.where(odd, w, got1))    # row r0 + 8
        col = nt * 8 + (lane & 3) * 2
        for e in range(2):
            keep[lane >> 2, col + e] = words[e] >= thr
            keep[(lane >> 2) + 8, col + e] = words[2 + e] >= thr
    return keep


@pytest.mark.parametrize("warp", [0, 3, 7])
def test_mma_lane_map_and_philox_pairing_reproduce_dropout_keep(warp):
    """A 16 x 128 tile of the forward kernel draws exactly
    ``_dropout_keep``'s bits through its lane map and lane pairing."""
    seed, bh, qi, kj, block, rate = 4321, 37, 2, 5, 128, 0.1
    want = T._dropout_keep(seed, bh, qi, kj, block, block, rate, "cpu") > 0
    got = _mma_tile_keep(seed, bh, qi, kj, warp, block, rate)
    assert torch.equal(got, want[16 * warp:16 * warp + 16])
    assert 0.85 < float(got.float().mean()) < 0.95


def _dkv_tile_keep(seed, bh, qi, kj, warp, block, rate):
    """The bf16 dk/dv kernel's keep mask of warp ``warp``'s 16 key rows
    against the block's queries, rebuilt from its transposed lane map and
    word exchange: in the Sᵀ accumulator lane t holds key rows
    r0 = 16 warp + t / 4 and r0 + 8 and queries c = 8 nt + 2 (t % 4) + {0,
    1}. The four keys of a Philox call (a key quad) lie in the four lanes
    whose row group g = (t / 4) % 4 differs: lane g makes call g of the
    n-tile (query c + (g & 1), the key quad of row r0 + 8 (g >> 1)), and
    in round k = 1, 2, 3 sends word g ^ k of its call to lane t ^ 4k
    (``__shfl_xor``), receiving word g of call g ^ k. Element e (row
    r0 + 8 (e >> 1), query c + (e & 1)) takes word g of call e. Returns
    (bool [16 keys, block queries], Philox calls made, times each element
    was written)."""
    thr = T._dropout_threshold(rate)
    lane = torch.arange(32)
    g = (lane >> 2) & 3
    r0 = 16 * warp + (lane >> 2)
    keep = torch.zeros(16, block, dtype=torch.bool)
    written = torch.zeros(16, block, dtype=torch.long)
    calls = 0
    for nt in range(block // 8):
        c = nt * 8 + (lane & 3) * 2
        words = T.philox4x32((qi, kj, c + (g & 1), (r0 >> 2) + (g & 2)), (seed, bh))
        bits = torch.stack(torch.broadcast_tensors(*words), dim=-1)      # [lane, word]
        calls += 32
        got = {k: bits[lane, g ^ k][lane ^ (k << 2)] for k in (1, 2, 3)}
        own = bits[lane, g]
        for e in range(4):
            k = e ^ g
            w = torch.where(k == 0, own, torch.where(k == 1, got[1],
                                                     torch.where(k == 2, got[2], got[3])))
            rows = (lane >> 2) + 8 * (e >> 1)
            keep[rows, c + (e & 1)] = w >= thr
            written[rows, c + (e & 1)] += 1
    return keep, calls, written


@pytest.mark.parametrize("warp", [0, 3, 7])
def test_dkv_lane_map_and_philox_exchange_reproduce_dropout_keep(warp):
    """The dk/dv kernel's transposed 16-key x 128-query slab of a warp
    draws exactly ``_dropout_keep``'s bits (transposed) through its lane
    map and xor-shuffle word exchange, with one Philox call per four
    elements and every element written once."""
    seed, bh, qi, kj, block, rate = 4321, 37, 2, 5, 128, 0.1
    want = T._dropout_keep(seed, bh, qi, kj, block, block, rate, "cpu") > 0  # [query, key]
    got, calls, written = _dkv_tile_keep(seed, bh, qi, kj, warp, block, rate)
    assert torch.equal(got, want[:, 16 * warp:16 * warp + 16].T)
    assert torch.equal(written, torch.ones_like(written))
    assert calls * 4 == got.numel()
    assert 0.85 < float(got.float().mean()) < 0.95


def _dq_tile_keep(seed, bh, qi, kj, warp, block, rate, slab):
    """The bf16 dq kernel's keep mask of warp ``warp``'s 16 query rows
    against a key block, rebuilt from its lane map over the block's slabs
    of ``slab`` keys: in the slab's S accumulator lane t holds rows
    r0 = 16 warp + t / 4 and r0 + 8 and keys c = cb + 8 nt + 2 (t % 4) +
    {0, 1}, cb the slab's first key. The call's column quad is c / 4, so
    lanes t and t ^ 1 share it: the even lane draws row r0's call, the odd
    lane row r0 + 8's, and each hands the other the two words of the
    other's keys (``__shfl_xor`` by 1). Returns (bool [16, block], Philox
    calls made, times each element was written)."""
    thr = T._dropout_threshold(rate)
    lane = torch.arange(32)
    odd = (lane & 1).bool()
    r0 = 16 * warp + (lane >> 2)
    keep = torch.zeros(16, block, dtype=torch.bool)
    written = torch.zeros(16, block, dtype=torch.long)
    calls = 0
    for cb in range(0, block, slab):
        for nt in range(slab // 8):
            c = cb + nt * 8 + (lane & 3) * 2
            x, y, z, w = T.philox4x32((qi, kj, torch.where(odd, r0 + 8, r0), c >> 2),
                                      (seed, bh))
            calls += 32
            send0, send1 = torch.where(odd, x, z), torch.where(odd, y, w)
            got0, got1 = send0[lane ^ 1], send1[lane ^ 1]
            words = (torch.where(odd, got0, x), torch.where(odd, got1, y),    # row r0
                     torch.where(odd, z, got0), torch.where(odd, w, got1))    # row r0 + 8
            for e in range(4):
                rows = (lane >> 2) + 8 * (e >> 1)
                keep[rows, c + (e & 1)] = words[e] >= thr
                written[rows, c + (e & 1)] += 1
    return keep, calls, written


@pytest.mark.parametrize("slab", [16, 32])
@pytest.mark.parametrize("warp", [0, 3, 7])
def test_dq_lane_map_and_philox_pairing_reproduce_dropout_keep(warp, slab):
    """The dq kernel's 16 query rows of a warp against a 128-key block,
    walked in slabs, draw exactly ``_dropout_keep``'s bits through the
    forward's lane map and pairing, with one Philox call per lane per
    eight keys and every element written once."""
    seed, bh, qi, kj, block, rate = 4321, 37, 2, 5, 128, 0.1
    want = T._dropout_keep(seed, bh, qi, kj, block, block, rate, "cpu") > 0
    got, calls, written = _dq_tile_keep(seed, bh, qi, kj, warp, block, rate, slab)
    assert torch.equal(got, want[16 * warp:16 * warp + 16])
    assert torch.equal(written, torch.ones_like(written))
    assert calls == 32 * block // 8
    assert 0.85 < float(got.float().mean()) < 0.95
