"""The serving engine's telemetry block in the port, held against the JAX
engine's (``tests/unit/test_fleet_telemetry.py``), and the public names
the JAX package exports.

With an enabled ``telemetry`` block both engines serve the endpoint on
``telemetry_server`` (the serving, kv_pool, prefix_cache, memtier and
kernels snapshots and the ``serving_loop`` health), evaluate the SLO
engine at the end of every step (``slo_policy: "fail"`` raises
``SloViolationError`` out of ``step()``), register the
``Serving/SpillTier`` and ``Serving/HostRssMb`` gauges and write
``trace_file`` on ``close()``. Armed, the port's decode step reads the
device exactly as often as unarmed. Tiny GPT-2 on the CPU.
"""

import argparse
import json
import urllib.request

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

import deepspeed_tpu  # noqa: E402
import deepspeed_tpu.inference as jinference  # noqa: E402
import deepspeed_tpu.inference.serving as jserving  # noqa: E402
import deepspeed_tpu_torch as dt  # noqa: E402
import deepspeed_tpu_torch.inference as tinference  # noqa: E402
import deepspeed_tpu_torch.inference.serving as tserving  # noqa: E402
from deepspeed_tpu import telemetry as jtelemetry  # noqa: E402
from deepspeed_tpu.models.gpt2 import GPT2Config as JGPT2Config  # noqa: E402
from deepspeed_tpu.models.gpt2 import init_gpt2 as jinit_gpt2  # noqa: E402
from deepspeed_tpu.telemetry.config import DeepSpeedTelemetryConfig as JTelemetryConfig  # noqa: E402
from deepspeed_tpu_torch import telemetry  # noqa: E402
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHeadModel  # noqa: E402
from deepspeed_tpu_torch.runtime.lr_schedules import add_tuning_arguments  # noqa: E402
from deepspeed_tpu_torch.telemetry import FleetCollector, SloViolationError  # noqa: E402
from deepspeed_tpu_torch.telemetry.config import DeepSpeedTelemetryConfig  # noqa: E402

TINY = dict(vocab_size=64, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
            max_position_embeddings=32, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)
SERVING = dict(max_slots=3, max_queue=8, max_seq_len=32, prompt_buckets=(4, 8),
               attention_impl={"default": "dense", 8: "pallas_decode"})
PROVIDERS = {"serving", "kv_pool", "prefix_cache", "memtier", "kernels"}


@pytest.fixture(autouse=True)
def _clean_global_telemetry():
    """Both packages' process-global tracers and registries are armed by
    the engines here: disarm and empty them afterwards."""
    yield
    for pkg in (telemetry, jtelemetry):
        pkg.configure(False)
        pkg.get_tracer().clear()
        reg = pkg.get_registry()
        for name in list(reg.as_dict(pulled=False)) + ["Serving/Snapshot", "Serving/SpillTier",
                                                       "Serving/HostRssMb", "Kernels"]:
            reg.unregister(name)


@pytest.fixture(scope="module")
def models():
    jcfg = JGPT2Config(**TINY)
    _, params = jinit_gpt2(jcfg, batch_size=2, seq_len=4, seed=0)
    tcfg = GPT2Config(**TINY)
    tmodel = GPT2LMHeadModel.from_jax_params(jax.tree_util.tree_map(np.asarray, params), tcfg)
    return jcfg, params, tcfg, tmodel


def _engines(models, block, **serving):
    """The JAX engine and the port's, each with its package's telemetry
    config built from the same ``telemetry`` block."""
    jcfg, params, tcfg, tmodel = models
    kw = {**SERVING, **serving}
    jeng = jserving.ServingEngine(params, jcfg, jserving.ServingConfig(**kw),
                                  telemetry_config=JTelemetryConfig({"telemetry": block}),
                                  rank=0)
    teng = tserving.ServingEngine(tmodel, tcfg, tserving.ServingConfig(**kw), device="cpu",
                                  telemetry_config=DeepSpeedTelemetryConfig({"telemetry": block}),
                                  rank=0)
    return jeng, teng


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return json.loads(r.read())


def _serve(eng, n_new=4):
    futs = [eng.submit(p, max_new_tokens=n_new) for p in ([5, 9, 2], [7, 1, 3, 3, 8])]
    eng.drain(max_steps=100)
    return [list(f.result(timeout=1)) for f in futs]


def test_endpoint_serves_the_jax_engines_document(models):
    jeng, teng = _engines(models, {"enabled": True, "http_port": 0})
    try:
        assert _serve(jeng) and _serve(teng)
        docs = {}
        for name, eng in (("jax", jeng), ("port", teng)):
            assert eng.telemetry_server is not None
            docs[name] = (_get(eng.telemetry_server.url + "/snapshot"),
                          _get(eng.telemetry_server.url + "/healthz"))
        (jsnap, jhealth), (tsnap, thealth) = docs["jax"], docs["port"]
        assert PROVIDERS <= set(jsnap) and set(jsnap) == set(tsnap)
        assert set(jsnap["kv_pool"]) == set(tsnap["kv_pool"])
        assert set(jsnap["memtier"]) == set(tsnap["memtier"])
        assert set(jsnap["serving"]) <= set(tsnap["serving"])
        assert tsnap["serving"]["tokens_emitted"] == jsnap["serving"]["tokens_emitted"] == 6
        # the same kernels, each with its launch count (none on the CPU)
        assert set(jsnap["kernels"]) <= set(tsnap["kernels"])
        assert tsnap["kernels"]["decode_attention"]["launches"] == 0
        loop = "serving_loop"
        assert jhealth["status"] == thealth["status"] == "ok"
        assert set(jhealth[loop]) == set(thealth[loop])
        assert thealth[loop]["steps"] == teng._step_count
        assert thealth[loop]["healthy"] is True
        # the kernels' launch gauges, as the JAX engine exports its backends
        assert "Kernels/decode_attention/launches" in telemetry.get_registry().as_dict()
    finally:
        jeng.close()
        teng.close()
    assert teng.telemetry_server is None


def test_slo_fail_policy_raises_from_step(models):
    block = {"enabled": True, "slo_policy": "fail",
             "slo": [{"metric": "Serving/tokens_emitted", "max": 1.0, "for_s": 0.0}]}
    jeng, teng = _engines(models, block)
    try:
        for eng, err in ((jeng, jtelemetry.SloViolationError), (teng, SloViolationError)):
            assert eng.slo is not None and eng.slo.policy == "fail"
            eng.submit([5, 9, 2], max_new_tokens=4)
            with pytest.raises(err) as ei:
                for _ in range(10):
                    eng.step()
            assert ei.value.metric == "Serving/tokens_emitted"
    finally:
        jeng.close()
        teng.close()


def test_slo_warn_policy_evaluates_every_step(models):
    _, _, tcfg, tmodel = models
    block = {"enabled": True, "slo": [{"metric": "Serving/ttft_p95_s", "max": 100.0,
                                       "for_s": 0.0}]}
    eng = tserving.ServingEngine(tmodel, tcfg, tserving.ServingConfig(**SERVING), device="cpu",
                                 telemetry_config=DeepSpeedTelemetryConfig({"telemetry": block}))
    calls = []
    evaluate = eng.slo.evaluate
    eng.slo.evaluate = lambda vals: calls.append(vals) or evaluate(vals)
    try:
        _serve(eng)
        assert len(calls) == eng._step_count > 0
        assert calls[-1]["Serving/tokens_emitted"] == 6 and not eng.slo.firing()
    finally:
        eng.close()


def test_trace_file_written_on_close(models, tmp_path):
    paths = {name: tmp_path / f"{name}.json" for name in ("jax", "port")}
    jcfg, params, tcfg, tmodel = models
    jeng = jserving.ServingEngine(
        params, jcfg, jserving.ServingConfig(**SERVING), rank=0,
        telemetry_config=JTelemetryConfig({"telemetry": {"enabled": True,
                                                         "trace_file": str(paths["jax"])}}))
    teng = tserving.ServingEngine(
        tmodel, tcfg, tserving.ServingConfig(**SERVING), device="cpu", rank=0,
        telemetry_config=DeepSpeedTelemetryConfig({"telemetry": {
            "enabled": True, "trace_file": str(paths["port"])}}))
    for eng in (jeng, teng):
        _serve(eng)
        eng.close()
    names = {}
    for name, path in paths.items():
        doc = json.loads(path.read_text())
        names[name] = {e["name"] for e in doc["traceEvents"] if e.get("ph") != "M"}
    assert {"serving/decode_step", "serving/prefill_batch", "serving/retire"} <= names["port"]
    assert names["port"] == names["jax"]


@pytest.mark.parametrize("gauge,serving", [
    ("Serving/SpillTier", dict(prefix_cache_mb=1.0, prefix_spill_mb=1.0)),
    ("Serving/HostRssMb", dict(host_mem_watermark_mb=1e6)),
])
def test_memory_gauges_registered(models, gauge, serving):
    jeng, teng = _engines(models, {"enabled": True}, **serving)
    try:
        jvals = jtelemetry.get_registry().as_dict()
        tvals = telemetry.get_registry().as_dict()
        jkeys = {k for k in jvals if k.startswith(gauge)}
        tkeys = {k for k in tvals if k.startswith(gauge)}
        assert jkeys and jkeys == tkeys
    finally:
        jeng.close()
        teng.close()


def test_collector_scrapes_the_engine_endpoint(models):
    _, _, tcfg, tmodel = models
    eng = tserving.ServingEngine(
        tmodel, tcfg, tserving.ServingConfig(**SERVING), device="cpu", rank=0,
        telemetry_config=DeepSpeedTelemetryConfig({"telemetry": {"enabled": True,
                                                                 "http_port": 0}}))
    coll = FleetCollector()
    try:
        coll.add_endpoint(0, eng.telemetry_server.url, role="serve")
        _serve(eng)
        coll.scrape()
        fleet = coll.fleet_metrics()
        assert fleet["Fleet/rank0/up"] == 1.0
    finally:
        eng.close()


def _host_reads(eng, steps):
    """Device-to-host reads (``.cpu``, ``.item``, ``.tolist``) made by
    ``steps`` steady-state decode steps."""
    counts = {"n": 0}
    originals = {name: getattr(torch.Tensor, name) for name in ("cpu", "item", "tolist")}

    def counting(name):
        def fn(self, *a, **kw):
            counts["n"] += 1
            return originals[name](self, *a, **kw)
        return fn

    rng = np.random.RandomState(1)
    futs = [eng.submit(rng.randint(0, 64, (3,)).tolist(), max_new_tokens=8) for _ in range(2)]
    eng.step()             # admission
    eng.step()             # the lane-churn upload
    try:
        for name in originals:
            setattr(torch.Tensor, name, counting(name))
        for _ in range(steps):
            assert eng.step()["decoded"] == 2
    finally:
        for name, fn in originals.items():
            setattr(torch.Tensor, name, fn)
    eng.drain(max_steps=100)
    for f in futs:
        f.result(timeout=1)
    return counts["n"]


def test_decode_reads_the_device_once_a_step_with_collector_and_slo_armed(models):
    """Arming the endpoint, the SLO engine and a collector scraping the
    engine adds no device read to a steady-state decode step: the step's
    one read of its tokens stays the only one."""
    _, _, tcfg, tmodel = models
    scfg = tserving.ServingConfig(**SERVING)
    plain = tserving.ServingEngine(tmodel, tcfg, scfg, device="cpu")
    armed = tserving.ServingEngine(
        tmodel, tcfg, scfg, device="cpu", rank=0,
        telemetry_config=DeepSpeedTelemetryConfig({"telemetry": {
            "enabled": True, "http_port": 0,
            "slo": [{"metric": "Serving/ttft_p95_s", "max": 100.0, "for_s": 0.0}]}}))
    coll = FleetCollector()
    try:
        coll.add_endpoint(0, armed.telemetry_server.url, role="serve")
        assert _host_reads(plain, 4) == 4
        assert _host_reads(armed, 4) == 4
        coll.scrape()
        assert coll.fleet_metrics()["Fleet/rank0/up"] == 1.0
        assert not armed.slo.firing()
    finally:
        plain.close()
        armed.close()


# -- the public surface --------------------------------------------------------

@pytest.mark.parametrize("name", ["add_config_arguments", "add_tuning_arguments",
                                  "ADAM_OPTIMIZER", "LAMB_OPTIMIZER"])
def test_top_level_exports_match_jax(name):
    ours, theirs = getattr(dt, name), getattr(deepspeed_tpu, name)
    if callable(theirs):
        pj, pt = argparse.ArgumentParser(), argparse.ArgumentParser()
        theirs(pj)
        ours(pt)
        assert ({a.dest: a.default for a in pj._actions}
                == {a.dest: a.default for a in pt._actions})
    else:
        assert ours == theirs
    assert add_tuning_arguments is dt.add_tuning_arguments


def test_inference_exports_cover_jax():
    # pipeline-checkpoint conversion comes with the pipeline slice
    later = {"pipe_layers_to_lm_params", "lm_params_from_pipeline_checkpoint"}
    assert set(jinference.__all__) - later <= set(tinference.__all__)
    for name in tinference.__all__:
        assert callable(getattr(tinference, name))


def test_serving_exports_cover_jax():
    assert set(jserving.__all__) <= set(tserving.__all__)
    for name in tserving.__all__:
        assert getattr(tserving, name) is not None


def test_greedy_generate_is_greedy(models):
    _, _, tcfg, tmodel = models
    prompt = torch.tensor([[5, 9, 2]])
    got = tinference.greedy_generate(tmodel, tcfg, prompt, 4, device="cpu")
    assert torch.equal(got, tinference.generate(tmodel, tcfg, prompt, 4, device="cpu"))
