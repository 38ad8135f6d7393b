"""A dropped serving engine frees its model and KV pool.

The degrade ladder's ``Fleet/degrade_rung`` gauge lives in the
process-global telemetry registry. The ladder once called back into the
engine through a bound method, so an engine whose ladder had been armed
(by ``set_degrade_rung``, ``configure_degrade`` or the memory-pressure
guard's climb) stayed alive with its weights and pool after its last
reference went away; on the card that held 8.6 GB after the serving
features' phase of ``chip_smoke.py``."""

import gc
import weakref

import numpy as np

from deepspeed_tpu_torch.inference.serving.config import DegradeConfig, ServingConfig
from deepspeed_tpu_torch.inference.serving.degrade import DegradeLadder
from deepspeed_tpu_torch.inference.serving.engine import ServingEngine
from deepspeed_tpu_torch.inference.serving.fault_injection import ServingFaultInjector
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, init_gpt2

_CFG = GPT2Config(vocab_size=64, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                  max_position_embeddings=64, hidden_dropout_prob=0.0,
                  attention_probs_dropout_prob=0.0)


def _engine(**knobs):
    scfg = ServingConfig(max_slots=4, max_seq_len=64, kv_page_tokens=8, **knobs)
    return ServingEngine(init_gpt2(_CFG, seed=0, device="cpu"), _CFG, scfg, device="cpu",
                         injector=ServingFaultInjector())


def _serve(eng, n=3):
    rng = np.random.RandomState(0)
    for _ in range(n):
        fut = eng.submit(rng.randint(0, 64, 20).tolist(), max_new_tokens=4)
        eng.drain()
        assert len(fut.result(timeout=1)) == 4


def _freed(box):
    """Drop the one engine in ``box``; True when it and its pool are gone."""
    ref, pool = weakref.ref(box[0]), weakref.ref(box[0].pool.k)
    box.clear()
    gc.collect()
    return ref() is None and pool() is None


def test_engine_with_an_armed_ladder_is_freed():
    eng = _engine()
    _serve(eng)
    eng.set_degrade_rung(1)
    assert eng.degrade_rung == 1               # the callback still reaches it
    box = [eng]
    del eng
    assert _freed(box)


def test_engine_whose_guard_climbed_the_ladder_is_freed():
    eng = _engine(prefix_cache_mb=0.05, host_mem_watermark_mb=float(1 << 20))
    _serve(eng)
    eng.injector.arm_serving("host_mem_pressure", times=6)
    for _ in range(6):
        eng.step()
    assert eng._mem_guard.level == 3 and eng.degrade_rung >= 1
    box = [eng]
    del eng
    assert _freed(box)


def test_engine_given_a_ladder_is_freed_and_the_ladder_outlives_it():
    ladder = DegradeLadder(DegradeConfig(enabled=True), name="engine")
    eng = _engine()
    eng.configure_degrade(ladder)
    ladder.set_rung(2, reason="test")
    assert eng.degrade_rung == 2
    box = [eng]
    del eng
    assert _freed(box)
    ladder.set_rung(0, reason="after the engine")   # a dead engine is skipped
    assert ladder.rung == 0
