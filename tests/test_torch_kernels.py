"""The port's kernels, held against the JAX package's on the same inputs.

On the CPU each wrapper of ``deepspeed_tpu_torch.kernels`` runs its
kernel's plain PyTorch version; the CUDA kernels themselves are held
against those plain versions on the card by ``chip_smoke.py``. Inputs are
drawn from numpy seeds and fed to both packages. The JAX kernels run as
the JAX tests run them: the Pallas body in interpret mode, and the XLA
fallback.

Tolerances: fp32 atol = rtol = 1e-5 (summation order differs between
the frameworks); bf16 pages 2e-2 (bf16 rounding of the stored keys and
values dominates); int8 pages 1e-4 (both sides see the same dequantized
values; only accumulation order differs).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from deepspeed_tpu import kernels as jkernels  # noqa: E402
from deepspeed_tpu_torch import kernels as tkernels  # noqa: E402
from deepspeed_tpu_torch.kernels import decode_attention as tdecode  # noqa: E402
from deepspeed_tpu_torch.kernels.decode_attention import _decode_attend_torch  # noqa: E402

F32 = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    yield


def _paged_case(seed, B, C, nh, pt, hd, mp, P):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, C, nh, hd).astype(np.float32)
    pk = rng.randn(P, nh, pt, hd).astype(np.float32)
    pv = rng.randn(P, nh, pt, hd).astype(np.float32)
    tables = np.stack([rng.permutation(P)[:mp] for _ in range(B)]).astype(np.int32)
    qpos = np.sort(rng.randint(0, mp * pt, (B, C)), axis=1).astype(np.int32)
    return q, pk, pv, tables, qpos


def _jax_decode(q, pk, pv, tables, qpos, pt, impl, dtype=jnp.float32, **kw):
    return np.asarray(jkernels.decode_attend(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(tables),
        jnp.asarray(qpos), page_tokens=pt, dtype=dtype, impl=impl,
        interpret=True, **kw), np.float32)


def _torch_decode(q, pk, pv, tables, qpos, pt, dtype=torch.float32, **kw):
    t = torch.from_numpy
    return tkernels.decode_attend(
        t(q), t(pk), t(pv), t(tables), t(qpos), page_tokens=pt, dtype=dtype,
        **kw).float().numpy()


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("shape", [
    (2, 1, 2, 4, 8, 2, 5),     # single-query decode step
    (1, 3, 4, 8, 16, 3, 7),    # multi-query chunk, odd C
    (3, 2, 2, 4, 8, 4, 9),     # more lanes than pages-per-lane
    (2, 11, 2, 4, 8, 3, 8),    # chunk wider than one query tile
])
def test_decode_attend_matches_jax(shape, impl):
    B, C, nh, pt, hd, mp, P = shape
    case = _paged_case(3, B, C, nh, pt, hd, mp, P)
    np.testing.assert_allclose(_torch_decode(*case, pt),
                               _jax_decode(*case, pt, impl), **F32)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_decode_attend_odd_positions_mid_page(impl):
    B, C, nh, pt, hd, mp, P = 2, 2, 2, 8, 8, 3, 7
    q, pk, pv, tables, _ = _paged_case(11, B, C, nh, pt, hd, mp, P)
    qpos = np.asarray([[0, 5], [9, 17]], np.int32)      # incl. position 0
    np.testing.assert_allclose(_torch_decode(q, pk, pv, tables, qpos, pt),
                               _jax_decode(q, pk, pv, tables, qpos, pt, impl),
                               **F32)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_decode_attend_int8_pages(impl):
    B, C, nh, pt, hd, mp, P = 2, 1, 2, 8, 16, 2, 5
    q, pk, pv, tables, qpos = _paged_case(5, B, C, nh, pt, hd, mp, P)
    sk = (np.abs(pk).max(axis=(2, 3)) / 127.0 + 1e-8).astype(np.float32)
    sv = (np.abs(pv).max(axis=(2, 3)) / 127.0 + 1e-8).astype(np.float32)
    qk = np.clip(np.rint(pk / sk[:, :, None, None]), -127, 127).astype(np.int8)
    qv = np.clip(np.rint(pv / sv[:, :, None, None]), -127, 127).astype(np.int8)
    got = _torch_decode(q, qk, qv, tables, qpos, pt, k_scale=torch.from_numpy(sk),
                        v_scale=torch.from_numpy(sv))
    want = _jax_decode(q, qk, qv, tables, qpos, pt, impl, k_scale=jnp.asarray(sk),
                       v_scale=jnp.asarray(sv))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_decode_attend_bf16_pages(impl):
    B, C, nh, pt, hd, mp, P = 2, 3, 2, 4, 8, 3, 7
    q, pk, pv, tables, qpos = _paged_case(9, B, C, nh, pt, hd, mp, P)
    pk_b = torch.from_numpy(pk).to(torch.bfloat16)
    pv_b = torch.from_numpy(pv).to(torch.bfloat16)
    got = tkernels.decode_attend(
        torch.from_numpy(q), pk_b, pv_b, torch.from_numpy(tables),
        torch.from_numpy(qpos), page_tokens=pt, dtype=torch.float32).numpy()
    want = np.asarray(jkernels.decode_attend(
        jnp.asarray(q), jnp.asarray(pk, jnp.bfloat16), jnp.asarray(pv, jnp.bfloat16),
        jnp.asarray(tables), jnp.asarray(qpos), page_tokens=pt, dtype=jnp.float32,
        impl=impl, interpret=True))
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)


def test_decode_attend_bf16_compute():
    """bf16 queries and pages end to end (the full-width serving dtype)."""
    B, C, nh, pt, hd, mp, P = 2, 3, 2, 4, 8, 3, 7
    q, pk, pv, tables, qpos = _paged_case(21, B, C, nh, pt, hd, mp, P)
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    got = tkernels.decode_attend(bf(q), bf(pk), bf(pv), torch.from_numpy(tables),
                                 torch.from_numpy(qpos), page_tokens=pt,
                                 dtype=torch.bfloat16).float().numpy()
    want = np.asarray(jkernels.decode_attend(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(pk, jnp.bfloat16),
        jnp.asarray(pv, jnp.bfloat16), jnp.asarray(tables), jnp.asarray(qpos),
        page_tokens=pt, dtype=jnp.bfloat16, impl="xla"), np.float32)
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_chunk_attend_matches_jax(impl):
    B, C, nh, pt, hd = 2, 2, 2, 4, 8
    S = 3 * pt
    rng = np.random.RandomState(7)
    q = rng.randn(B, C, nh, hd).astype(np.float32)
    ck = rng.randn(B, nh, S, hd).astype(np.float32)
    cv = rng.randn(B, nh, S, hd).astype(np.float32)
    qpos = np.asarray([[3, 6], [7, 11]], np.int32)
    got = tkernels.chunk_attend(torch.from_numpy(q), torch.from_numpy(ck),
                                torch.from_numpy(cv), torch.from_numpy(qpos), pt,
                                torch.float32).numpy()
    want = np.asarray(jkernels.chunk_attend(
        jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(qpos), pt,
        jnp.float32, impl=impl, interpret=True))
    np.testing.assert_allclose(got, want, **F32)


def test_decode_plain_version_is_chunk_invariant():
    """A query's bits do not depend on how many queries share its call or
    how many trailing masked pages its table has — what the serving
    oracle rests on."""
    B, C, nh, pt, hd, mp, P = 1, 13, 2, 4, 8, 4, 9
    q, pk, pv, tables, _ = _paged_case(2, B, C, nh, pt, hd, mp, P)
    qpos = np.arange(C, dtype=np.int32)[None]
    t = torch.from_numpy
    full = _decode_attend_torch(t(q), t(pk), t(pv), t(tables), t(qpos), pt,
                                torch.float32, None, None)
    head = _decode_attend_torch(t(q[:, :9]), t(pk), t(pv), t(tables[:, :3]),
                                t(qpos[:, :9]), pt, torch.float32, None, None)
    assert torch.equal(full[:, :9], head)


def _band_case(null_sink):
    N, nh, W, pt, hd = 5, 2, 12, 4, 8
    rng = np.random.RandomState(13)
    arrs = [rng.randn(*s).astype(np.float32) for s in
            ((N, nh, hd), (N, nh, W, hd), (N, nh, W, hd), (N, nh, pt, hd),
             (N, nh, pt, hd))]
    if null_sink:
        base = np.zeros(N, np.int32)
        pos = np.asarray([0, 3, 5, 8, 11], np.int32)
    else:
        base = np.asarray([4, 4, 8, 8, 12], np.int32)
        pos = base + np.asarray([0, 5, 3, 11, 7], np.int32)
    return arrs + [pos, base]


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("null_sink", [False, True])
def test_band_attend_matches_jax(null_sink, impl):
    case = _band_case(null_sink)
    got = tkernels.band_attend(*map(torch.from_numpy, case),
                               dtype=torch.float32).numpy()
    want = np.asarray(jkernels.band_attend(*map(jnp.asarray, case),
                                           dtype=jnp.float32, impl=impl,
                                           interpret=True))
    np.testing.assert_allclose(got, want, **F32)


def test_band_attend_bf16():
    case = _band_case(False)
    bf = [torch.from_numpy(a).to(torch.bfloat16) for a in case[:5]]
    got = tkernels.band_attend(*bf, *map(torch.from_numpy, case[5:]),
                               dtype=torch.bfloat16).float().numpy()
    want = np.asarray(jkernels.band_attend(
        *[jnp.asarray(a, jnp.bfloat16) for a in case[:5]],
        *map(jnp.asarray, case[5:]), dtype=jnp.bfloat16, impl="xla"), np.float32)
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)


def _band_torch(case, dtype):
    ts = [torch.from_numpy(a) for a in case]
    return tkernels.band_attend(*[t.to(dtype) for t in ts[:5]], *ts[5:], dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("null_sink", [False, True])
def test_band_plain_version_ignores_masked_keys(null_sink, dtype):
    """The plain version's output does not change, bit for bit, when the
    K and V rows of masked keys (window keys after the query's position;
    the whole sink page when base == 0) hold other finite values: the
    CUDA kernel never loads those rows."""
    case = _band_case(null_sink)
    q, kw, vw, ks, vs, pos, base = case
    W, pt = kw.shape[2], ks.shape[2]
    rng = np.random.RandomState(29)
    kw2, vw2, ks2, vs2 = (a.copy() for a in (kw, vw, ks, vs))
    for i in range(q.shape[0]):
        late = base[i] + np.arange(W) > pos[i]
        kw2[i][:, late] = 100.0 * rng.randn(kw.shape[1], int(late.sum()), kw.shape[3])
        vw2[i][:, late] = 100.0 * rng.randn(vw.shape[1], int(late.sum()), vw.shape[3])
        hidden = np.arange(pt) >= base[i]
        ks2[i][:, hidden] = 100.0 * rng.randn(ks.shape[1], int(hidden.sum()), ks.shape[3])
        vs2[i][:, hidden] = 100.0 * rng.randn(vs.shape[1], int(hidden.sum()), vs.shape[3])
    assert not np.array_equal(kw, kw2)
    if null_sink:
        assert not np.array_equal(ks, ks2)
    want = _band_torch(case, dtype)
    got = _band_torch([q, kw2, vw2, ks2, vs2, pos, base], dtype)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("null_sink", [False, True])
def test_band_plain_version_is_query_invariant(null_sink, dtype):
    """A query computed alone equals, bit for bit, its row among N: the
    band's counterpart of the decode chunk invariance, which the served
    == one-shot oracle rests on."""
    case = _band_case(null_sink)
    full = _band_torch(case, dtype)
    for i in range(case[0].shape[0]):
        alone = _band_torch([a[i:i + 1] for a in case], dtype)
        assert torch.equal(alone[0], full[i])


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("C", [8, 3])        # a multiple of pt; k+1 wide
def test_chunk_band_attend_matches_jax(C, impl):
    B, nh, pt, hd = 2, 2, 4, 8
    S = 6 * pt
    rng = np.random.RandomState(17)
    ck = rng.randn(B, nh, S, hd).astype(np.float32)
    cv = rng.randn(B, nh, S, hd).astype(np.float32)
    q = rng.randn(B, C, nh, hd).astype(np.float32)
    qpos = np.stack([np.arange(C) + 9, np.arange(C) + 14]).astype(np.int32)
    got = tkernels.chunk_band_attend(torch.from_numpy(q), torch.from_numpy(ck),
                                     torch.from_numpy(cv), torch.from_numpy(qpos),
                                     pt, torch.float32).numpy()
    want = np.asarray(jkernels.chunk_band_attend(
        jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(qpos), pt,
        jnp.float32, impl=impl, interpret=True))
    np.testing.assert_allclose(got, want, **F32)


def test_registry_names_and_counts():
    assert tkernels.kernel_for_backend("pallas_decode") == "decode_attention"
    assert tkernels.kernel_for_backend("pallas_sparse") == "sparse_attention"
    assert tkernels.kernel_for_backend("dense") is None
    tkernels.reset_launch_counts()
    # the plain versions on the CPU launch nothing
    _torch_decode(*_paged_case(3, 1, 1, 2, 4, 8, 2, 3), 4)
    snap = tkernels.registry_snapshot()
    assert set(snap) == set(tkernels.KERNEL_NAMES)
    assert all(v["launches"] == 0 and v["route"] == "cuda" for v in snap.values())


def test_wrappers_reject_other_devices():
    q = torch.zeros(1, 1, 1, 64, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tkernels.decode_attend(q, torch.zeros(2, 1, 4, 64, device="meta"),
                               torch.zeros(2, 1, 4, 64, device="meta"),
                               torch.zeros(1, 1, dtype=torch.int32),
                               torch.zeros(1, 1, dtype=torch.int32),
                               page_tokens=4, dtype=torch.float32)


# ---------------------------------------------------------------------------
# the CUDA kernel's split of the cache across blocks, mirrored in PyTorch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pt", [1, 7, 100, 128, 129, 256])
def test_split_plan_is_a_function_of_page_size_alone(pt):
    """Boundaries are fixed key positions: a wider table only appends
    splits, every page lies in exactly one split, no split is longer than
    the kernel's limit (unless one page is), and the scratch is sized by
    the plan whatever the batch and the chunk width."""
    bounds = {mp: tdecode.split_bounds(pt, mp) for mp in (1, 2, 5, 8, 64, 300)}
    widest = bounds[300]
    for mp, b in bounds.items():
        assert b[:-1] == widest[:len(b) - 1]                # a prefix of the wider plan
        assert b[-1][0] == widest[len(b) - 1][0] and b[-1][1] == mp * pt
        assert b[0][0] == 0 and all(x[1] == y[0] for x, y in zip(b, b[1:]))
        assert all(s % pt == 0 and e % pt == 0 for s, e in b)
        assert all(0 < e - s <= max(tdecode._SPLIT_KEYS, pt) for s, e in b)
        pps, nsplit = tdecode.split_plan(pt, mp)
        assert nsplit == len(b) and pps * pt == widest[0][1]
        for B, C in ((1, 1), (8, 1), (8, 40), (3, 512)):
            acc, ml = tdecode._scratch_shapes(B, C, 25, 64, nsplit)
            assert acc == (len(b), B, C, 25, 64) and ml == (len(b), B, C, 25, 2)


def _split_attend(q, pk, pv, tables, qpos, pt):
    """One lane (B = 1) the way the kernel computes it: every split's
    pages through ``_page_update`` from an empty carry, then the partials
    merged in ascending key order."""
    _, C, nh, hd = q.shape
    mp = tables.shape[1]
    qb = q[0].permute(1, 0, 2)[None]                        # [1, nh, C, hd]
    scale = tdecode._attn_scale(hd, torch.float32, False)
    koff = torch.arange(pt)
    empty = lambda: (torch.full((1, nh, C), -1e30), torch.zeros(1, nh, C),
                     torch.zeros(1, nh, C, hd))
    carry = empty()
    pps, nsplit = tdecode.split_plan(pt, mp)
    for s in range(nsplit):
        part = empty()
        for j in range(s * pps, min((s + 1) * pps, mp)):
            pid = int(tables[0, j])
            valid = (j * pt + koff)[None, :] <= qpos[0][:, None]        # [C, pt]
            part = tdecode._page_update(qb, pk[pid], pv[pid], valid[None, None],
                                        *part, scale)
        carry = tdecode._merge_partial(carry, part)
    m, l, acc = carry
    return (acc / torch.clamp_min(l, 1e-30)[..., None])[0].permute(1, 0, 2)   # [C, nh, hd]


@pytest.mark.parametrize("C", [1, 5])
def test_split_and_merge_equals_plain_version(C, monkeypatch):
    """Cutting a lane's keys at the planned boundaries and merging the
    partials in ascending order is the plain version's attention (1e-6),
    and trailing parts the queries cannot see change nothing, bit for bit."""
    monkeypatch.setattr(tdecode, "_SPLIT_KEYS", 8)          # 2 pages a split
    nh, pt, hd, mp, P = 2, 4, 8, 7, 12
    q, pk, pv, tables, _ = _paged_case(21, 1, C, nh, pt, hd, mp, P)
    qpos = np.sort(np.random.RandomState(4).randint(0, 4 * pt, (1, C)), axis=1)
    qpos = qpos.astype(np.int32)                            # the last 3 pages are unseen
    t = torch.from_numpy
    assert tdecode.split_plan(pt, mp) == (2, 4)
    got = _split_attend(t(q), t(pk), t(pv), t(tables), t(qpos), pt)
    want = _decode_attend_torch(t(q), t(pk), t(pv), t(tables), t(qpos), pt,
                                torch.float32, None, None)[0]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
    seen = int(qpos.max()) // pt + 1
    short = _split_attend(t(q), t(pk), t(pv), t(tables[:, :seen].copy()), t(qpos), pt)
    assert torch.equal(short, got)
