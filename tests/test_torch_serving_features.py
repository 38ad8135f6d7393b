"""The port's serving features beside speculation, after the JAX package's
``tests/unit/test_serving.py`` (chunked prefill, the prefix cache, fault
injection, ``from_config``) and ``tests/unit/test_selfheal.py`` (the
degrade ladder), on the CPU. Served tokens are held to the port's
``generate()`` on the same backend.
"""

import time

import numpy as np
import pytest

import torch

from deepspeed_tpu_torch import telemetry
from deepspeed_tpu_torch.inference.generation import generate
from deepspeed_tpu_torch.inference.serving.config import DegradeConfig, ServingConfig
from deepspeed_tpu_torch.inference.serving.degrade import (
    MAX_RUNG,
    DegradeLadder,
    rung_name,
)
from deepspeed_tpu_torch.inference.serving.engine import ServingEngine
from deepspeed_tpu_torch.inference.serving.fault_injection import (
    SERVING_POINTS,
    ServingFaultInjector,
)
from deepspeed_tpu_torch.inference.serving.prefix_cache import PrefixKVCache
from deepspeed_tpu_torch.inference.serving.scheduler import (
    QueueFullError,
    RequestTimeoutError,
)
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, init_gpt2

BACKENDS = ("dense", "flash", "sparse_xla", "pallas_decode", "pallas_sparse")


@pytest.fixture(scope="module")
def model():
    cfg = GPT2Config(vocab_size=64, hidden_size=32, num_hidden_layers=2,
                     num_attention_heads=4, max_position_embeddings=32,
                     hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    return cfg, init_gpt2(cfg, seed=0, device="cpu")


def _engine(cfg, params, injector=None, **overrides):
    kw = dict(max_slots=2, max_queue=8, max_seq_len=32, prompt_buckets=(4, 8),
              kv_page_tokens=4)
    kw.update(overrides)
    return ServingEngine(params, cfg, ServingConfig(**kw), injector=injector, device="cpu")


def _prompts(n, lengths=(4, 6, 3, 5, 8, 2, 7, 4)):
    rng = np.random.RandomState(7)
    return [rng.randint(0, 64, (lengths[i % len(lengths)],)).tolist() for i in range(n)]


def _shared_prefix_prompts(n, prefix_len=5):
    rng = np.random.RandomState(11)
    prefix = rng.randint(0, 64, (prefix_len,)).tolist()
    return [prefix + rng.randint(0, 64, (1 + i % 3,)).tolist() for i in range(n)]


def _oneshot(cfg, params, prompt, n_new, impl="dense"):
    return generate(params, cfg, [prompt], n_new, attn_impl=impl, kv_page_tokens=4,
                    device="cpu").tolist()[0]


# -- chunked prefill ------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_chunked_prefill_oracle_and_interleaving(model, backend):
    """A long prompt prefills in chunks between decode steps: the short
    request keeps emitting while the long one progresses, both correct."""
    cfg, params = model
    eng = _engine(cfg, params, prefill_chunk_tokens=3, attention_impl=backend)
    short, long_p = _prompts(2, lengths=(3, 8))
    f_short = eng.submit(short, max_new_tokens=8)
    eng.step()                                   # short admitted, decoding
    f_long = eng.submit(long_p, max_new_tokens=4)
    chunk_steps = decode_during_chunks = 0
    while not f_long.done():
        stats = eng.step()
        if stats["prefill_chunks"]:
            chunk_steps += stats["prefill_chunks"]
            decode_during_chunks += stats["decoded"]
        assert stats["prefill_chunks"] <= 1      # one chunk a step
    eng.drain(max_steps=100)
    assert chunk_steps == 3                      # ceil(8 / 3)
    assert decode_during_chunks >= 1
    assert f_short.result(timeout=1) == _oneshot(cfg, params, short, 8, backend)
    assert f_long.result(timeout=1) == _oneshot(cfg, params, long_p, 4, backend)
    assert eng.metrics.snapshot()["prefill_chunks"] == 3


def test_chunked_prefill_deadline_aborts_with_prefill_phase(model):
    cfg, params = model
    eng = _engine(cfg, params, prefill_chunk_tokens=2)
    doomed = eng.submit(_prompts(1, lengths=(8,))[0], max_new_tokens=4, timeout_s=60.0)
    eng.step()                                   # chunked prefill started
    assert eng._chunking is not None
    eng._chunking.req.timeout_s = 1e-6           # expire it mid-prefill
    eng.drain(max_steps=100)
    with pytest.raises(RequestTimeoutError) as ei:
        doomed.result(timeout=1)
    assert ei.value.phase == "prefill" and ei.value.tokens_done == 0
    assert eng.occupancy()["in_use"] == 0        # the reserved slot reclaimed


# -- the prefix cache -----------------------------------------------------------

def test_prefix_refs_released_after_stuck_reap(model):
    """A stuck request holding a prefix-cache ref is reaped by its
    deadline; the reap releases the ref."""
    cfg, params = model
    fi = ServingFaultInjector()
    fi.arm_serving("stuck_request", request_id=1)
    eng = _engine(cfg, params, injector=fi, prefix_cache_mb=4.0)
    prompts = _shared_prefix_prompts(2)
    seed = eng.submit(prompts[0], max_new_tokens=2)          # id 0: inserts
    eng.drain(max_steps=100)
    seed.result(timeout=1)
    stuck = eng.submit(prompts[1], max_new_tokens=2, timeout_s=0.3)   # id 1: hits
    eng.drain(max_steps=5000)
    with pytest.raises(RequestTimeoutError) as ei:
        stuck.result(timeout=1)
    # its natural retirement was suppressed: only the deadline reaped it
    assert ei.value.phase == "decoding" and fi.fired["stuck_request"] >= 1
    stats = eng.prefix_stats()
    assert stats["hits"] >= 1 and stats["referenced"] == 0
    assert eng.occupancy()["in_use"] == 0


def test_prefix_cache_entries_segregated_by_impl(model):
    """The same prefix stored under two backends is two entries; an entry
    filled under ``pallas_sparse`` never seeds a ``dense`` lane."""
    c = PrefixKVCache(budget_bytes=1 << 20)
    k = torch.zeros((2, 2, 3, 4))
    c.insert((1, 2, 3), k, k.clone())
    assert c.match((1, 2, 3))[0] == 3
    assert c.match((1, 2, 3), impl="pallas_sparse") == (0, None)
    c.insert((1, 2, 3), k.clone(), k.clone(), impl="pallas_sparse")
    assert c.match((1, 2, 3), impl="pallas_sparse")[1].impl == "pallas_sparse"
    assert len(c) == 2
    cfg, params = model
    # lengths 5 and 6 (bucket 8: pallas_sparse), then 4 (bucket 4: dense)
    prompts = [_shared_prefix_prompts(3, prefix_len=3)[i] for i in (1, 2, 0)]
    eng = _engine(cfg, params, prefix_cache_mb=4.0,
                  attention_impl={"default": "dense", 8: "pallas_sparse"})
    for p in prompts:
        fut = eng.submit(p, max_new_tokens=4)
        eng.drain(max_steps=100)
        impl = eng._impl_for_len(len(p))
        assert fut.result(timeout=1) == _oneshot(cfg, params, p, 4, impl)
    impls = {e.impl for e in eng.prefix_cache._by_key.values()}
    assert impls == {"dense", "pallas_sparse"}
    assert eng.prefix_stats()["hits"] == 1           # the dense lane missed


# -- fault injection and from_config --------------------------------------------

def test_fault_injection_via_config_and_slow_decode(model):
    cfg, params = model
    eng = _engine(cfg, params, fault_injection={"slow_decode": {"at_step": 1,
                                                                "seconds": 0.05}})
    assert isinstance(eng.injector, ServingFaultInjector)
    prompt = _prompts(1)[0]
    t0 = time.monotonic()
    fut = eng.submit(prompt, max_new_tokens=3)
    eng.drain(max_steps=100)
    assert time.monotonic() - t0 >= 0.05
    assert eng.injector.fired["slow_decode"] == 1
    assert fut.result(timeout=1) == _oneshot(cfg, params, prompt, 3)


def test_replica_arms_are_parsed_and_armed():
    fi = ServingFaultInjector({"kill_replica": {"at_step": 4},
                               "slow_replica": {"seconds": 0.1, "times": 1},
                               "reject_admission": {"times": 2},
                               "evict_under_decode": {"at_step": 3}})
    assert set(fi._serving_arms) == {"kill_replica", "slow_replica", "reject_admission",
                                     "evict_under_decode"}
    assert fi.reply_delay_s() == 0.1 and fi.reply_delay_s() == 0.0
    assert fi.admission_rejected() and fi.admission_rejected()
    assert not fi.admission_rejected()
    killed = []
    fi._kill = lambda: killed.append(1)
    fi.maybe_kill_replica(3)
    fi.maybe_kill_replica(4)
    assert killed == [1]
    assert "corrupt_draft" in SERVING_POINTS
    with pytest.raises(ValueError, match="unknown serving fault point"):
        fi.arm_serving("nope")


def test_evict_under_decode_is_output_invisible(model):
    cfg, params = model
    fi = ServingFaultInjector({"evict_under_decode": {}})
    eng = _engine(cfg, params, injector=fi, prefix_cache_mb=4.0, speculative_k=2)
    prompts = _shared_prefix_prompts(4)
    futs = [eng.submit(p, max_new_tokens=5) for p in prompts]
    eng.drain(max_steps=300)
    assert fi.fired["evict_under_decode"] >= 1
    for p, f in zip(prompts, futs):
        assert f.result(timeout=1) == _oneshot(cfg, params, p, 5)


def test_from_config_builds_the_serving_block(model):
    cfg, params = model
    ds = {"train_micro_batch_size_per_gpu": 1, "gradient_accumulation_steps": 1,
          "serving": {"max_slots": 2, "prompt_buckets": [4, 8], "max_seq_len": 32,
                      "kv_page_tokens": 4, "speculative_k": 2, "prefill_chunk_tokens": 3,
                      "prefix_cache_mb": 1.0,
                      "attention_impl": {"default": "flash", "8": "pallas_decode"},
                      "fault_injection": {"corrupt_draft": {"times": 2}}},
          "telemetry": {"enabled": True}}
    try:
        eng = ServingEngine.from_config(params, cfg, ds, device="cpu")
        assert eng.config.speculative_k == 2 and eng._impl_map == {8: "pallas_decode"}
        prompts = _prompts(3)
        futs = [eng.submit(p, max_new_tokens=5) for p in prompts]
        eng.drain(max_steps=200)
        for p, f in zip(prompts, futs):
            assert f.result(timeout=1) == _oneshot(cfg, params, p, 5, eng._impl_for_len(len(p)))
        assert eng.injector.fired["corrupt_draft"] == 2
        names = {e.get("name") for e in telemetry.get_tracer().events()}
        assert {"serving/decode_step", "serving/prefill_batch",
                "serving/prefill_chunk", "serving/retire"} <= names
        assert "Serving/Snapshot/accept_rate" in telemetry.get_registry().as_dict()
    finally:
        telemetry.configure(False)
        telemetry.get_tracer().events(drain=True)
        telemetry.get_registry().unregister("Serving/Snapshot")
    # the fleet block is parsed as the JAX package parses it, and its
    # degrade sub-block arms the engine's ladder
    eng = ServingEngine.from_config(
        params, cfg, dict(ds, telemetry={"enabled": False},
                          fleet={"replicas": 2, "degrade": {"escalate_after_s": 0.1}}),
        device="cpu")
    try:
        assert eng._degrade is not None and eng._degrade.config.escalate_after_s == 0.1
    finally:
        eng.close()


# -- the degrade ladder -----------------------------------------------------------

def test_ladder_escalates_and_recovers_rung_by_rung():
    t = [0.0]
    changes = []
    lad = DegradeLadder(DegradeConfig(enabled=True, escalate_after_s=1.0,
                                      recover_after_s=2.0),
                        on_change=lambda o, n, r: changes.append((o, n)),
                        clock=lambda: t[0])
    lad.update(True)
    for now, want in ((0.5, 0), (1.0, 1), (1.5, 1), (2.0, 2), (3.0, 3), (9.0, MAX_RUNG)):
        t[0] = now
        assert lad.update(True) == want
    lad.update(False)
    for now, want in ((11.0, 2), (13.0, 1), (15.0, 0)):
        t[0] = now
        assert lad.update(False) == want
    assert changes == [(0, 1), (1, 2), (2, 3), (3, 2), (2, 1), (1, 0)]
    assert rung_name(2) == "budget_shrink"


def test_engine_rungs_turn_speculation_off_and_shrink_admission(model):
    """Rung 1 turns speculation off mid-flight with the output unchanged;
    rung 2 halves the admission queue and pauses prefix inserts."""
    cfg, params = model
    eng = _engine(cfg, params, speculative_k=3, prefix_cache_mb=4.0, max_queue=4)
    prompts = _prompts(3)
    futs = [eng.submit(p, max_new_tokens=10) for p in prompts]
    eng.step()
    eng.step()
    assert eng.metrics.draft_proposed > 0
    assert eng.set_degrade_rung(1) == 1 and eng._effective_spec_k() == 0
    proposed = eng.metrics.draft_proposed
    eng.step()
    assert eng.metrics.draft_proposed == proposed       # a one-token step
    eng.set_degrade_rung(0)
    eng.drain(max_steps=200)
    for p, f in zip(prompts, futs):
        assert f.result(timeout=1) == _oneshot(cfg, params, p, 10)
    eng.set_degrade_rung(2)
    assert eng._degrade_queue_budget() == 2
    entries = len(eng.prefix_cache)
    more = _shared_prefix_prompts(2)
    for p in more:
        eng.submit(p, max_new_tokens=2)
    with pytest.raises(QueueFullError, match="rung 2"):
        eng.submit(more[0], max_new_tokens=2)
    eng.drain(max_steps=100)
    assert len(eng.prefix_cache) == entries             # inserts paused
    assert eng.memtier_stats()["prefix_cache"]["entries"] == entries


def test_engine_ladder_climbs_on_queue_pressure(model):
    cfg, params = model
    eng = _engine(cfg, params, max_queue=4, max_slots=1)
    eng.configure_degrade(DegradeConfig(enabled=True, escalate_after_s=0.0,
                                        recover_after_s=0.0, pressure_queue_frac=0.5))
    for p in _prompts(4):
        eng.submit(p, max_new_tokens=6)
    eng.step()
    assert eng.degrade_rung >= 1
    eng.drain(max_steps=300)
    for _ in range(4):
        eng.step()
    assert eng.degrade_rung == 0
