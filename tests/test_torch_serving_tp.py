"""The port's serving engine on a tensor-parallel mesh against the JAX
package's (``deepspeed_tpu/inference/serving/engine.py:1067-1095``).

A 2-layer GPT-2 (4 heads of 16, fp32) from the JAX package's initial
weights serves the same requests three ways: the port at mesh (1, 2) as
two gloo processes (``tests/torch_parallel_workers.py``: rank 0 submits,
rank 1 follows its plans), the port on one process, and the JAX
``ServingEngine`` at ``mesh_shape=(1, 2)`` on its 8 virtual CPU devices.
The served tokens are equal, over the dense, paged-decode and band
backends by prompt bucket, with chunked prefill and the prefix cache on a
second pass, and under speculative decoding. Each rank's KV pool holds 2
of the 4 heads (half of one process's bytes), and the blocks' projections
are Megatron layers. A ``parallel`` block through ``from_config`` serves
what the knob serves; 3 heads at model 2 raise the JAX engine's message;
a request whose deadline passes on rank 0's clock only (rank 0's clock
jumps 1000 s after step 3) is retired by both ranks at the same step, and
rank 1 refuses a ``submit()``.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from deepspeed_tpu.inference.serving.config import ServingConfig as JServingConfig  # noqa: E402
from deepspeed_tpu.inference.serving.engine import ServingEngine as JServingEngine  # noqa: E402
from deepspeed_tpu.models.gpt2 import GPT2Config as JGPT2Config  # noqa: E402
from deepspeed_tpu.models.gpt2 import init_gpt2 as jinit_gpt2  # noqa: E402
from deepspeed_tpu_torch.inference.serving.config import ServingConfig  # noqa: E402
from deepspeed_tpu_torch.inference.serving.engine import ServingEngine  # noqa: E402
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHeadModel  # noqa: E402
from tests import torch_parallel_workers as W  # noqa: E402

TINY = dict(vocab_size=64, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
            max_position_embeddings=32, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)
PROMPTS = [[5, 9, 3], [7, 1], [2, 2, 4, 6, 1], [9, 8, 7, 6, 5, 4, 3]]
MIXED = {"default": "dense", 4: "pallas_decode", 8: "pallas_sparse"}
BASE = dict(max_slots=3, max_queue=16, max_seq_len=32, prompt_buckets=(2, 4, 8),
            kv_page_tokens=4)
CASES = {
    "mixed": dict(BASE, attention_impl=MIXED),
    "chunked_prefix": dict(BASE, attention_impl="pallas_decode", prefill_chunk_tokens=4,
                           prefix_cache_mb=1.0),
    "speculative": dict(BASE, attention_impl="pallas_decode", speculative_k=2),
}
JAX_CASES = ("mixed", "chunked_prefix")
NEW = 5
TIMEOUT_S = 100.0


def _requests(timeouts=None):
    return [(p, NEW, None if timeouts is None else timeouts[i]) for i, p in enumerate(PROMPTS)]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    jcfg = JGPT2Config(**TINY)
    _, params = jinit_gpt2(jcfg, batch_size=2, seq_len=4, seed=0)
    np_params = jax.tree_util.tree_map(np.asarray, params)
    cases = {name: {"serving": dict(kw, mesh_shape=(1, 2)),
                    "passes": 2 if name == "chunked_prefix" else 1}
             for name, kw in CASES.items()}
    cases["from_config"] = {"serving": {"from_config": {
        "train_batch_size": 1, "serving": dict(CASES["mixed"], prompt_buckets=[2, 4, 8]),
        "parallel": {"mesh_shape": {"model": 2}}}}}
    cases["heads3"] = {"serving": dict(BASE, mesh_shape=(1, 2)),
                       "model": dict(TINY, hidden_size=48, num_attention_heads=3)}
    cases["deadline"] = {"serving": dict(CASES["mixed"], mesh_shape=(1, 2)),
                         "jump": (3, 10 * TIMEOUT_S),
                         "requests": _requests([None, TIMEOUT_S, None, None])}
    spec = {"model": TINY, "params": np_params, "requests": _requests(), "cases": cases}
    got = W.spawn(W.serving_tp_worker, 2, tmp_path_factory.mktemp("serve_tp"), spec)
    jax_tokens = {}
    for name in JAX_CASES:
        jeng = JServingEngine(params, jcfg, JServingConfig(**CASES[name], mesh_shape=(1, 2)))
        futs = []
        for _ in range(cases[name]["passes"]):
            futs += [jeng.submit(p, max_new_tokens=NEW) for p in PROMPTS]
            jeng.drain(max_steps=300)
        jax_tokens[name] = [[int(t) for t in f.result(timeout=1)] for f in futs]
    model = GPT2LMHeadModel.from_jax_params(np_params, GPT2Config(**TINY))
    one = {name: _serve_one_process(model, kw, cases[name]["passes"])
           for name, kw in CASES.items()}
    return dict(got=got, jax=jax_tokens, one=one)


def _serve_one_process(model, kw, passes=1):
    eng = ServingEngine(model, GPT2Config(**TINY), ServingConfig(**kw), device="cpu")
    futs = []
    for _ in range(passes):
        futs += [eng.submit(p, max_new_tokens=NEW) for p in PROMPTS]
        eng.drain(max_steps=300)
    return eng, [list(f.result(timeout=1)) for f in futs]


@pytest.mark.parametrize("name", list(CASES))
def test_tp2_serves_what_one_process_serves(served, name):
    got = served["got"][0][name]
    assert "error" not in got, got
    assert got["tokens"] == served["one"][name][1]
    assert got["steps"] == served["got"][1][name]["steps"]
    if name == "chunked_prefix":
        assert got["prefix"]["hits"] >= len(PROMPTS)
        assert got["prefix"] == served["got"][1][name]["prefix"]


@pytest.mark.parametrize("name", JAX_CASES)
def test_tp2_serves_what_the_jax_mesh_engine_serves(served, name):
    assert served["got"][0][name]["tokens"] == served["jax"][name]


def test_pool_holds_a_ranks_heads_and_layers_are_megatron(served):
    eng = served["one"]["mixed"][0]
    whole = tuple(eng.pool.k.shape)
    for r in range(2):
        got = served["got"][r]["mixed"]
        assert got["pool_shape"] == whole[:2] + (whole[2] // 2,) + whole[3:]
        assert 2 * got["pool_bytes"] == eng.pool.nbytes()
        assert got["layer_types"] == ["ColumnParallelLinear", "RowParallelLinear",
                                      "ColumnParallelLinear", "RowParallelLinear",
                                      "Embedding"]
    assert "rank 1 of a serving mesh" in served["got"][1]["mixed"]["tokens"]


def test_parallel_block_through_from_config_equals_the_knob(served):
    assert served["got"][0]["from_config"]["tokens"] == served["got"][0]["mixed"]["tokens"]
    assert served["got"][0]["from_config"]["pool_shape"][2] == 2


def test_heads_the_model_axis_does_not_divide_raise_the_jax_message(served):
    for r in range(2):
        assert served["got"][r]["heads3"]["error"] == (
            "ValueError: serving.mesh_shape model axis 2 must divide "
            "num_attention_heads=3 (the KV pool shards heads)")


def test_deadline_on_rank0_clock_retires_on_both_ranks_at_one_step(served):
    r0, r1 = (served["got"][r]["deadline"] for r in range(2))
    assert r0["steps"] == r1["steps"]
    first = [s for s, timed_out, _ in r0["steps"] if timed_out == 1]
    assert first and first[0] == 4          # the plan after the jump
    assert r0["tokens"][1] == "RequestTimeoutError"
    assert all(isinstance(t, list) and len(t) == NEW
               for i, t in enumerate(r0["tokens"]) if i != 1)
