"""The config surface of the port's tensor parallelism and 1-bit Adam.

``initialize(mpu=...)``, the ``tensor_parallel`` and ``mesh`` sections and
``optimizer onebitadam`` are accepted (the batch triple resolved at the
data-parallel size, as the JAX engine resolves it); a
``mesh.data_parallel_size`` that does not cover the world with
``tensor_parallel`` is refused by name (one process a rank: the launcher
sizes the world); ZeRO-3 with tensor parallelism is refused with the JAX
engine's message. The ``parallel`` section parses as the JAX package's
``get_parallel_config`` does, forms and errors alike (the cases of
``tests/unit/test_sharding_registry.py:169-252``); the serving mesh knobs
build an engine, and serving partition rules that restate the built-in
placements are honored while any other placement is refused, naming the
leaf; ZeRO, the mesh sections and ``mpu=`` build a pipeline.
"""

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch as dt
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, init_gpt2
from deepspeed_tpu_torch.inference.serving.config import ServingConfig
from deepspeed_tpu_torch.runtime import config as tconfig
from deepspeed_tpu_torch.runtime.config_utils import resolve_dp_size, resolve_tp_size
from deepspeed_tpu_torch.runtime.pipe.module import PipelineModule


class _Net(torch.nn.Module):
    def __init__(self):
        super().__init__()
        torch.manual_seed(0)
        self.ff1 = torch.nn.Linear(8, 16)
        self.ff2 = torch.nn.Linear(16, 8)

    def forward(self, x, y):
        return ((self.ff2(torch.relu(self.ff1(x))) - y) ** 2).mean()


class _Mpu:
    """An external Megatron mpu of one process, or one reporting
    ``mp`` model ranks (with no groups: the engine must refuse before it
    needs them)."""

    def __init__(self, mp=1):
        self.mp = mp

    def get_model_parallel_world_size(self):
        return self.mp

    def get_data_parallel_world_size(self):
        return 1

    def get_model_parallel_rank(self):
        return 0

    def get_data_parallel_rank(self):
        return 0

    def get_model_parallel_group(self):
        return None

    def get_data_parallel_group(self):
        return None


def _cfg(**kw):
    cfg = {"train_batch_size": 4, "optimizer": {"type": "Adam", "params": {"lr": 1e-2}}}
    cfg.update(kw)
    return cfg


def _step(engine):
    g = torch.Generator().manual_seed(0)
    batch = (torch.randn(4, 8, generator=g), torch.randn(4, 8, generator=g))
    return float(engine.train_step([batch]))


@pytest.mark.parametrize("kw", [
    dict(tensor_parallel={"size": 1}), dict(mesh={"data_parallel_size": 1}),
    dict(tensor_parallel={"size": 1}, mesh={"data_parallel_size": 1}),
    dict(optimizer={"type": "OneBitAdam", "params": {"lr": 1e-2, "freeze_step": 2}}),
])
def test_sections_and_onebitadam_are_accepted(kw):
    engine, _, _, _ = dt.initialize(model=_Net(), config=_cfg(**kw), device="cpu")
    assert (engine.dp_world_size, engine.mp_world_size) == (1, 1)
    assert not engine._onebit        # one data rank: the dense path
    losses = [_step(engine) for _ in range(3)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_mpu_is_accepted_and_its_groups_used():
    mpu = _Mpu()
    engine, _, _, _ = dt.initialize(model=_Net(), config=_cfg(), mpu=mpu, device="cpu")
    assert engine.mpu is mpu and engine.mesh.group("data") is None
    assert np.isfinite(_step(engine))
    assert resolve_tp_size({}, _Mpu(mp=4)) == 4
    assert resolve_tp_size({"tensor_parallel": {"size": 2}}) == 2
    assert resolve_dp_size({"mesh": {"data_parallel_size": 3}}) == 3
    assert resolve_dp_size({}) is None


def test_mesh_data_parallel_size_must_cover_the_world():
    with pytest.raises(ValueError, match="launcher sizes the world"):
        dt.initialize(model=_Net(), config=_cfg(mesh={"data_parallel_size": 2}), device="cpu")


def test_zero3_with_tensor_parallel_is_refused_with_jax_message():
    with pytest.raises(AssertionError, match="ZeRO-3 with tensor parallelism is not "
                                             "supported yet"):
        dt.initialize(model=_Net(), config=_cfg(zero_optimization={"stage": 3}),
                      mpu=_Mpu(mp=2), device="cpu")


def test_batch_triple_resolves_at_the_data_parallel_size():
    cfg = tconfig.DeepSpeedConfig({"train_batch_size": 16, "tensor_parallel": {"size": 2},
                                   "gradient_accumulation_steps": 2}, world_size=2)
    assert cfg.train_micro_batch_size_per_gpu == 4


@pytest.mark.parametrize("section", [
    {"parallel": {"mesh_shape": [1, 2]}}, {"parallel": {"partition_rules": []}},
])
def test_parallel_section_is_still_refused(section):
    """No longer refused: the section parses as the JAX package's does."""
    from deepspeed_tpu.runtime import config as jconfig

    got = tconfig.DeepSpeedConfig({"train_batch_size": 4, **section}, world_size=1)
    want = jconfig.get_parallel_config(section)
    assert got.parallel_config.enabled and vars(got.parallel_config) == vars(want)


def _parse(get, section):
    try:
        return vars(get(section))
    except ValueError as e:
        return f"ValueError: {e}"


@pytest.mark.parametrize("section", [
    {}, {"parallel": {}}, {"parallel": {"enabled": False, "mesh_shape": [1, 2]}},
    {"parallel": {"mesh_shape": [1, 4]}}, {"parallel": {"mesh_shape": (2, 2)}},
    {"parallel": {"mesh_shape": {"model": 2}}}, {"parallel": {"mesh_shape": {"data": 2}}},
    {"parallel": {"mesh_shape": {"rows": 2}}}, {"parallel": {"mesh_shape": [1, 2, 3]}},
    {"parallel": {"mesh_shape": 4}}, {"parallel": {"mesh_shape": [1, 0]}},
    {"parallel": {"mesh_shape": [1, True]}}, {"parallel": {"mesh_shape": [1, 2.0]}},
    {"parallel": {"mesh_shape": [1, 2],
                  "partition_rules": [["qkv/kernel$", [None, None, "model"]]]}},
    {"parallel": {"partition_rules": [["(", [None]]]}},
    {"parallel": {"partition_rules": [["x", ["pipe"]]]}},
    {"parallel": {"partition_rules": ["x"]}},
    {"parallel": {"partition_rules": "x"}},
    {"parallel": {"partition_rules": [[1, [None]]]}},
    {"parallel": {"replicate_unmatched": "yes"}},
    {"parallel": {"replicate_unmatched": False, "partition_rules": []}},
])
def test_get_parallel_config_equals_jax(section):
    """Forms, defaults and error messages of ``get_parallel_config`` are
    the JAX package's."""
    from deepspeed_tpu.runtime import config as jconfig

    assert _parse(tconfig.get_parallel_config, section) == \
        _parse(jconfig.get_parallel_config, section)


def _tiny_serving_model(heads=2):
    cfg = GPT2Config(vocab_size=64, hidden_size=16 * heads, num_hidden_layers=1,
                     num_attention_heads=heads, max_position_embeddings=32)
    return init_gpt2(cfg, device="cpu"), cfg


@pytest.mark.parametrize("knob", [{"mesh_shape": (1, 2)},
                                  {"partition_rules": [["qkv", [None, "model"]]]}])
def test_serving_mesh_knobs_point_at_slice_8c(knob):
    """Slice 8c ported them: a mesh of two ranks needs two processes (the
    registry's named error at world 1); rules without a mesh build the
    single-device engine."""
    from deepspeed_tpu_torch.inference.serving.engine import ServingEngine
    from deepspeed_tpu_torch.parallel.sharding_registry import ShardingRegistryError

    model, cfg = _tiny_serving_model()
    if "mesh_shape" in knob:
        with pytest.raises(ShardingRegistryError, match=r"needs 2 ranks, have 1"):
            ServingEngine(model, cfg, ServingConfig(**knob), device="cpu")
    else:
        eng = ServingEngine(model, cfg, ServingConfig(**knob), device="cpu")
        assert eng.mesh is None and eng.local_heads == 2


@pytest.mark.parametrize("rules", [
    None, [], [["qkv/kernel$", [None, None, "model"]]],
    [["(attn_out|ff2)/kernel$", [None, "model", None]], ["ln_f/scale$", []]],
    [["^serving/kv_pool$", [None, None, "model", None, None]]],
])
def test_serving_rules_restating_the_builtin_placements_are_honored(rules):
    from deepspeed_tpu_torch.inference.serving.engine import ServingEngine

    model, cfg = _tiny_serving_model()
    eng = ServingEngine(model, cfg, ServingConfig(mesh_shape=(1, 1), partition_rules=rules),
                        device="cpu")
    assert eng.mesh is not None and eng.pool.n_heads == 2


@pytest.mark.parametrize("rules,leaf", [
    ([["wte/embedding$", ["model", None]]], "params/transformer/wte/embedding"),
    ([["qkv/kernel$", [None, "model", None]]],
     "params/transformer/layers/DeepSpeedTransformerLayer_0/qkv/kernel"),
    ([["ff1/kernel$", []]], "params/transformer/layers/DeepSpeedTransformerLayer_0/ff1/kernel"),
    ([["ln_f/scale$", ["model"]]], "params/transformer/ln_f/scale"),
    ([["^serving/kv_pool$", [None, "model"]]], "serving/kv_pool"),
    ([["ff2/kernel$", [None, "data", None]]],
     "params/transformer/layers/DeepSpeedTransformerLayer_0/ff2/kernel"),
])
def test_serving_rules_placing_a_leaf_elsewhere_are_refused_by_name(rules, leaf):
    from deepspeed_tpu_torch.inference.serving.engine import ServingEngine

    model, cfg = _tiny_serving_model()
    with pytest.raises(NotImplementedError, match=f"place '{leaf}' as"):
        ServingEngine(model, cfg, ServingConfig(mesh_shape=(1, 1), partition_rules=rules),
                      device="cpu")


def test_serving_engine_from_config_takes_the_parallel_block():
    from deepspeed_tpu_torch.inference.serving.engine import ServingEngine

    model, cfg = _tiny_serving_model()
    eng = ServingEngine.from_config(model, cfg, {
        "train_batch_size": 1, "serving": {"max_seq_len": 32},
        "parallel": {"mesh_shape": {"model": 1}}}, device="cpu")
    assert eng.mesh is not None and eng.config.mesh_shape == (1, 1)
    assert ServingEngine.from_config(model, cfg, {"train_batch_size": 1},
                                     device="cpu").mesh is None


@pytest.mark.parametrize("extra,kw", [
    ({"tensor_parallel": {"size": 1}}, {}),
    ({"mesh": {"data_parallel_size": 1}}, {}),
    ({"zero_optimization": {"stage": 2}}, {}),
    ({}, {"mpu": _Mpu()}),
])
def test_zero_and_tp_under_the_pipeline_point_at_slice_8c(extra, kw):
    """Slice 8c ported them: each builds a pipeline that trains; a model
    size the world does not divide raises the JAX pipe's message."""
    layers = [torch.nn.Linear(8, 8), torch.nn.Linear(8, 8)]
    module = PipelineModule(layers, num_stages=2,
                            loss_fn=lambda out, y: ((out - y) ** 2).mean())
    engine, _, _, _ = dt.initialize(model=module, config_params=_cfg(**extra), device="cpu",
                                    **kw)
    g = torch.Generator().manual_seed(0)
    batch = (torch.randn(4, 8, generator=g), torch.randn(4, 8, generator=g))
    assert np.isfinite(engine.train_batch(iter([batch])))
    module = PipelineModule([torch.nn.Linear(8, 8)], num_stages=1,
                            loss_fn=lambda out, y: ((out - y) ** 2).mean())
    with pytest.raises(AssertionError, match="devices per stage 1 not divisible by "
                                             "tensor_parallel size 2"):
        dt.initialize(model=module, config_params=_cfg(tensor_parallel={"size": 2}),
                      device="cpu")
