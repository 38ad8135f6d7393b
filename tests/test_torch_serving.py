"""The port's ``ServingEngine``: continuous batching against the port's own
``generate()`` and against the JAX engine.

Inside the port the served greedy tokens equal ``generate()`` on the same
backend for every arrival order (the contract of
``tests/unit/test_kernels.py``), for fp32 pools and for bf16 pools on a
bf16 model (storage == compute dtype). An int8 pool quantizes the cache,
so its tokens are held to a match-rate threshold instead. Across the two
packages the served tokens are equal for the same weights and requests.
"""

import copy

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from deepspeed_tpu.inference.serving.config import ServingConfig as JServingConfig  # noqa: E402
from deepspeed_tpu.inference.serving.engine import ServingEngine as JServingEngine  # noqa: E402
from deepspeed_tpu.models.gpt2 import GPT2Config as JGPT2Config  # noqa: E402
from deepspeed_tpu.models.gpt2 import init_gpt2 as jinit_gpt2  # noqa: E402
from deepspeed_tpu_torch import kernels  # noqa: E402
from deepspeed_tpu_torch.inference.generation import generate  # noqa: E402
from deepspeed_tpu_torch.inference.serving import engine as engine_mod  # noqa: E402
from deepspeed_tpu_torch.inference.serving.config import ServingConfig  # noqa: E402
from deepspeed_tpu_torch.inference.serving.engine import ServingEngine  # noqa: E402
from deepspeed_tpu_torch.inference.serving.kv_pool import (  # noqa: E402
    KVCachePool,
    PageStateError,
    PoolExhaustedError,
)
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHeadModel  # noqa: E402

TINY = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, max_position_embeddings=32,
            hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
PROMPTS = [[5, 9, 3], [7, 1], [2, 2, 4, 6, 1], [9, 8, 7, 6, 5, 4, 3]]
MIXED = {"default": "dense", 4: "pallas_decode", 8: "pallas_sparse"}


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    yield


@pytest.fixture(scope="module")
def models():
    jcfg = JGPT2Config(**TINY)
    _, params = jinit_gpt2(jcfg, batch_size=2, seq_len=4, seed=0)
    tcfg = GPT2Config(**TINY)
    tmodel = GPT2LMHeadModel.from_jax_params(
        jax.tree_util.tree_map(np.asarray, params), tcfg)
    return jcfg, params, tcfg, tmodel


def _engine(model, cfg, **overrides):
    kw = dict(max_slots=3, max_queue=8, max_seq_len=32, prompt_buckets=(2, 4, 8),
              kv_page_tokens=4)
    kw.update(overrides)
    return ServingEngine(model, cfg, ServingConfig(**kw), device="cpu")


def _serve_mixed_arrival(eng, prompts, n_new=6):
    """Half the requests up front, the rest after a few steps: lanes join
    and retire around each other and pages get reused."""
    half = len(prompts) // 2
    futs = [eng.submit(p, max_new_tokens=n_new + i % 3)
            for i, p in enumerate(prompts[:half])]
    for _ in range(3):
        eng.step()
    futs += [eng.submit(p, max_new_tokens=n_new + (half + i) % 3)
             for i, p in enumerate(prompts[half:])]
    eng.drain(max_steps=300)
    return [list(f.result(timeout=1)) for f in futs]


def _oneshot(model, cfg, prompt, n_new, impl):
    return generate(model, cfg, [prompt], n_new, attn_impl=impl, kv_page_tokens=4,
                    device="cpu").tolist()[0]


def _impl_of(prompt, spec):
    if isinstance(spec, str):
        return spec
    bucket = next(b for b in (2, 4, 8) if len(prompt) <= b)
    return spec.get(bucket, spec["default"])


@pytest.mark.parametrize("kv", ["fp32", "bf16"])
@pytest.mark.parametrize("spec", ["dense", "pallas_decode", "pallas_sparse", "mixed"])
def test_served_tokens_equal_generate(models, spec, kv):
    _, _, cfg, model = models
    spec = MIXED if spec == "mixed" else spec
    if kv == "bf16":
        model = copy.deepcopy(model).to(torch.bfloat16)
    eng = _engine(model, cfg, attention_impl=spec, kv_cache_dtype=kv)
    assert eng._qmode is None                # storage == compute dtype
    got = _serve_mixed_arrival(eng, PROMPTS)
    for i, (p, g) in enumerate(zip(PROMPTS, got)):
        want = _oneshot(model, cfg, p, 6 + i % 3, _impl_of(p, spec))
        assert g == want, (spec, kv, p, g, want)


def test_int8_pool_threshold(models):
    """int8 KV under the band backend against fp32 ``generate()``: the
    requantization noise breaks bitwise equality by design, so parity is
    the match-rate threshold of tests/unit/test_serving.py."""
    _, _, cfg, model = models
    eng = _engine(model, cfg, attention_impl="pallas_sparse", kv_cache_dtype="int8")
    got = _serve_mixed_arrival(eng, PROMPTS)
    matches = total = 0
    for i, (p, g) in enumerate(zip(PROMPTS, got)):
        want = _oneshot(model, cfg, p, 6 + i % 3, "pallas_sparse")
        assert len(g) == len(want)
        matches += sum(a == b for a, b in zip(g, want))
        total += len(want)
    assert matches / total >= 0.9


@pytest.mark.parametrize("spec", ["dense", "pallas_decode", "pallas_sparse"])
def test_int8_pool_equals_jax_int8_pool(models, spec):
    """The same int8 storage and scales in both packages: the kernels read
    int8 pages directly, so the served tokens are the JAX engine's (the
    analog of the int8 kernel-vs-seam check in tests/unit/test_kernels.py)."""
    jcfg, params, cfg, model = models
    kw = dict(max_slots=3, max_queue=8, max_seq_len=32, prompt_buckets=(2, 4, 8),
              kv_page_tokens=4, attention_impl=spec, kv_cache_dtype="int8")
    jeng = JServingEngine(params, jcfg, JServingConfig(**kw))
    jfuts = [jeng.submit(p, max_new_tokens=8) for p in PROMPTS]
    jeng.drain(max_steps=300)
    teng = ServingEngine(model, cfg, ServingConfig(**kw), device="cpu")
    tfuts = [teng.submit(p, max_new_tokens=8) for p in PROMPTS]
    teng.drain(max_steps=300)
    for jf, tf in zip(jfuts, tfuts):
        assert list(tf.result(timeout=1)) == [int(t) for t in jf.result(timeout=1)]


def test_bf16_pool_on_fp32_model_casts_at_use(models):
    _, _, cfg, model = models
    eng = _engine(model, cfg, attention_impl="pallas_decode", kv_cache_dtype="bf16")
    assert eng._qmode == "bf16" and eng.pool.k.dtype == torch.bfloat16
    got = _serve_mixed_arrival(eng, PROMPTS)
    assert [len(g) for g in got] == [6 + i % 3 for i in range(len(PROMPTS))]


@pytest.mark.parametrize("spec", ["dense", "pallas_decode", "pallas_sparse", "mixed"])
def test_served_tokens_equal_jax_engine(models, spec):
    jcfg, params, cfg, model = models
    spec = MIXED if spec == "mixed" else spec
    kw = dict(max_slots=3, max_queue=8, max_seq_len=32, prompt_buckets=(2, 4, 8),
              kv_page_tokens=4, attention_impl=spec)
    jeng = JServingEngine(params, jcfg, JServingConfig(**kw))
    jfuts = [jeng.submit(p, max_new_tokens=6) for p in PROMPTS]
    jeng.drain(max_steps=300)
    teng = ServingEngine(model, cfg, ServingConfig(**kw), device="cpu")
    tfuts = [teng.submit(p, max_new_tokens=6) for p in PROMPTS]
    teng.drain(max_steps=300)
    for jf, tf in zip(jfuts, tfuts):
        assert list(tf.result(timeout=1)) == [int(t) for t in jf.result(timeout=1)]


def test_freed_pages_are_reused_without_corruption(models):
    """One slot, so every request reuses the pages its predecessor freed:
    each must still see exactly its own cache."""
    _, _, cfg, model = models
    eng = _engine(model, cfg, max_slots=1, attention_impl="pallas_decode",
                  kv_pool_tokens=32)
    futs = [eng.submit(p, max_new_tokens=5) for p in PROMPTS]
    eng.drain(max_steps=300)
    assert eng.pool.allocations == len(PROMPTS) and eng.pool.frees == len(PROMPTS)
    for p, f in zip(PROMPTS, futs):
        assert list(f.result(timeout=1)) == _oneshot(model, cfg, p, 5, "pallas_decode")


@pytest.mark.parametrize("impl", ["dense", "pallas_decode", "pallas_sparse"])
def test_inactive_lanes_write_only_the_null_page(models, impl):
    _, _, cfg, model = models
    pool = KVCachePool(2, 3, 4, 32, 8, kv_cache_dtype="fp32", page_tokens=4,
                       device="cpu")
    slot = pool.allocate(12)
    pool.positions[slot] = 5
    with torch.no_grad():
        pool.k.normal_()
        pool.v.normal_()
    before_k, before_v = pool.k.clone(), pool.v.clone()
    tables = torch.as_tensor(pool.page_tables)
    active = torch.tensor([True, False, False])
    tokens = torch.tensor([3, 7, 9])
    positions = torch.tensor([5, 13, 31])     # inactive lanes at stale positions
    with torch.no_grad():
        engine_mod._DECODE_STEPS[impl](model, pool, tables, tokens, positions,
                                       active, 4, None, torch.float32)
    changed = ((pool.k != before_k) | (pool.v != before_v)).any(dim=(0, 2, 3, 4))
    own = pool.page_tables[slot, 5 // 4]
    assert set(torch.nonzero(changed)[:, 0].tolist()) <= {0, int(own)}
    assert bool(changed[own])


def test_pool_lifecycle_errors():
    pool = KVCachePool(1, 2, 1, 16, 8, page_tokens=4, pool_tokens=16, device="cpu")
    a = pool.allocate(16)
    with pytest.raises(PoolExhaustedError):
        pool.allocate(4)
    pool.free(a)
    with pytest.raises(PageStateError):
        pool.free(a)
    assert pool.occupancy()["pages_free"] == 4


def test_metrics_record_ttft_and_throughput(models):
    _, _, cfg, model = models
    eng = _engine(model, cfg, attention_impl=MIXED)
    _serve_mixed_arrival(eng, PROMPTS)
    snap = eng.metrics.snapshot()
    assert snap["requests_completed"] == len(PROMPTS)
    assert snap["ttft_p50_s"] is not None and snap["tokens_per_sec"] > 0
    assert eng.occupancy()["in_use"] == 0


def test_cpu_engine_launches_no_kernel(models):
    _, _, cfg, model = models
    kernels.reset_launch_counts()
    eng = _engine(model, cfg, attention_impl=MIXED)
    _serve_mixed_arrival(eng, PROMPTS[:2])
    counts = kernels.launch_counts()
    assert {"decode_attention", "sparse_attention"} <= set(counts)
    assert counts == dict.fromkeys(kernels.KERNEL_NAMES, 0)


def test_engine_rejects_unported_and_tpu_knobs(models):
    """The mesh knobs build an engine now (a (1, 1) mesh at world 1, rules
    without a mesh the single-device engine; the mesh is tested in
    test_torch_serving_tp.py), and so do the slice's knobs and the flash
    backend (test_torch_speculative.py, test_torch_serving_features.py)."""
    _, _, cfg, model = models
    assert _engine(copy.deepcopy(model), cfg, mesh_shape=(1, 1)).mesh is not None
    assert _engine(model, cfg, partition_rules=(("x", None),)).mesh is None
    for knob, val in (("speculative_k", 2), ("prefill_chunk_tokens", 4),
                      ("prefix_cache_mb", 1.0), ("host_mem_watermark_mb", 10.0),
                      ("fault_injection", {"slow_decode": {"seconds": 0.0}})):
        assert getattr(_engine(model, cfg, **{knob: val}).config, knob) == val
    assert _engine(model, cfg, attention_impl="flash")._impl_default == "flash"
    with pytest.raises(ValueError, match="attn_impl"):
        _engine(model, cfg, attention_impl="nope")
    eng = _engine(model, cfg)
    for bad in ([5, 64], [-1, 3]):
        with pytest.raises(ValueError, match="token ids"):
            eng.submit(bad, max_new_tokens=2)
    for knob, val in (("attention_kernel", "pallas"), ("kernel_interpret", True)):
        with pytest.raises(ValueError, match="TPU-only"):
            _engine(model, cfg, attention_impl="pallas_decode", **{knob: val})
    _engine(model, cfg, attention_impl="pallas_decode", attention_kernel=None,
            kernel_interpret=None)


def test_engine_requires_cuda_by_default(models):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, _, cfg, model = models
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(model, cfg, ServingConfig(max_seq_len=32), device=None)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(model, cfg, ServingConfig(max_seq_len=32))


def test_background_loop(models):
    _, _, cfg, model = models
    eng = _engine(model, cfg, attention_impl="pallas_sparse")
    eng.start()
    try:
        futs = [eng.submit(p, max_new_tokens=4) for p in PROMPTS[:2]]
        got = [list(f.result(timeout=60)) for f in futs]
    finally:
        eng.close()
    for p, g in zip(PROMPTS[:2], got):
        assert g == _oneshot(model, cfg, p, 4, "pallas_sparse")


def test_decode_kernel_is_told_the_stage(models, monkeypatch):
    """The decode kernel picks its bf16 routine by the stage its caller
    names: every prefill, a one-token prompt's too, says ``prefill=True``
    in serving (a bucket-wide chunk) and in ``generate()`` (the exact
    length), and every decode step is one query a lane without it."""
    from deepspeed_tpu_torch.kernels import decode_attention as da

    _, _, cfg, model = models
    calls = []
    real = da.decode_attend

    def spy(q, *args, prefill=False, **kw):
        calls.append((q.shape[1], prefill))
        return real(q, *args, prefill=prefill, **kw)

    monkeypatch.setattr(da, "decode_attend", spy)
    monkeypatch.setattr(kernels, "decode_attend", spy)
    L = cfg.num_hidden_layers
    prompt = [7]
    want = _oneshot(model, cfg, prompt, 3, "pallas_decode")
    assert calls[:L] == [(1, True)] * L               # the one-token prefill
    assert set(calls[L:]) == {(1, False)} and len(calls) == 3 * L
    calls.clear()
    eng = _engine(model, cfg, attention_impl="pallas_decode")
    fut = eng.submit(prompt, max_new_tokens=3)
    eng.drain(max_steps=50)
    assert list(fut.result(timeout=1)) == want
    assert calls[:L] == [(2, True)] * L               # the smallest bucket
    assert set(calls[L:]) == {(1, False)}
