"""The port's ZeRO stages 1-3, held against stage 0 and the JAX package.

Tiny BERT (2 layers, hidden 64, sequence 128 so the attention runs the
flash kernels' plain versions) through ``initialize()`` on the CPU, one
process. Tolerances:

- stages 1, 2 and 3 against stage 0 in the port, at world 1: bit for bit,
  with gradient clipping off and on. Each rank steps one view per
  parameter of its slice of the flat master, so one rank applies the very
  ``torch._foreach_*`` operations of the unsharded engine, and the norm
  is taken over the same per-parameter pieces in the same order;
- the config, the bucket plan and the memory estimator against the JAX
  package exactly.

The trajectories against the JAX engine are in test_torch_zero_jax.py.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import deepspeed_tpu_torch as dt  # noqa: E402
from __graft_entry__ import _bert_batch, _tiny_bert_config  # noqa: E402
from deepspeed_tpu.models.bert import BertForPreTraining as JBert  # noqa: E402
from deepspeed_tpu.ops import utils_op as jutils_op  # noqa: E402
from deepspeed_tpu.runtime import config as jconfig  # noqa: E402
from deepspeed_tpu.runtime.zero import mem_estimator as jmem  # noqa: E402
from deepspeed_tpu.runtime.zero.sharded_optimizer import (  # noqa: E402
    compute_bucket_ranges as jbuckets,
)
from deepspeed_tpu_torch.models.bert import (  # noqa: E402
    BertConfig,
    BertForPreTraining,
    bert_init_plan,
)
from deepspeed_tpu_torch.ops import utils_op  # noqa: E402
from deepspeed_tpu_torch.runtime import config as tconfig  # noqa: E402
from deepspeed_tpu_torch.runtime.zero import mem_estimator as tmem  # noqa: E402
from deepspeed_tpu_torch.runtime.zero.sharded_optimizer import (  # noqa: E402
    ALIGN,
    ZeroShardedOptimizer,
    compute_bucket_ranges,
)

SEQ = 128
_TO_NP = lambda tree: jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Tiny tensors gain nothing from many threads; the test workers
    share the machine."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _jcfg():
    return dataclasses.replace(_tiny_bert_config(), max_position_embeddings=SEQ)


def _tcfg(jcfg, **kw):
    d = dataclasses.asdict(jcfg)
    d.pop("scan_unroll")
    d.update(kw)
    return BertConfig(**d)


@pytest.fixture(scope="module")
def bert():
    jcfg = _jcfg()
    batch = _bert_batch(2, SEQ, 256, 0)
    params = JBert(jcfg).init({"params": jax.random.PRNGKey(0),
                               "dropout": jax.random.PRNGKey(1)},
                              *(jnp.asarray(x) for x in batch))
    return jcfg, params


# ---------------------------------------------------------------------------
# layout, buckets, config, estimator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sizes,bucket", [
    ([10, 1000, 10], 100), ([4, 4, 4, 4, 4], 8), ([1, 2, 3], 1000), ([], 5),
    ([7] * 9, 21), ([0, 5, 0, 5], 5), ([30528 * 64, 64, 64 * 192, 192], 10000)])
def test_compute_bucket_ranges_matches_jax(sizes, bucket):
    assert compute_bucket_ranges(sizes, bucket) == jbuckets(sizes, bucket)


@pytest.mark.parametrize("align", [1, 8])
def test_flat_layout_matches_jax_and_views_alias(align):
    rng = np.random.RandomState(0)
    arrays = [rng.randn(*s).astype(np.float32) for s in ((3, 4), (5,), (2, 1, 3), (1,))]
    ts = [torch.from_numpy(a) for a in arrays]
    flat = utils_op.flatten_dense_tensors(ts, align=align)
    shapes, dtypes, sizes = utils_op.tree_spec(ts)
    assert sizes == jutils_op.tree_spec(arrays)[3] and dtypes == [torch.float32] * 4
    if align == 1:
        np.testing.assert_array_equal(flat.numpy(), np.asarray(
            jutils_op.flatten_dense_tensors(arrays)))
    else:
        assert utils_op.flat_offsets(sizes, align)[0] == [0, 16, 24, 32]
    views = utils_op.unflatten_dense_tensors(flat, shapes, align=align)
    for v, a in zip(views, arrays):
        np.testing.assert_array_equal(v.numpy(), a)
    flat.mul_(2)                                   # views, not copies
    np.testing.assert_array_equal(views[2].numpy(), 2 * arrays[2])
    padded, n = utils_op.pad_to_multiple(torch.arange(5.0), 4)
    jpadded, jn = jutils_op.pad_to_multiple(jnp.arange(5.0), 4)
    np.testing.assert_array_equal(padded.numpy(), np.asarray(jpadded))
    assert n == jn == 5


@pytest.mark.parametrize("zero", [
    {"stage": 2, "cpu_offload": True, "offload_stream_buckets": 4},
    {"stage": 3, "overlap_comm": True, "reduce_bucket_size": 1000,
     "allgather_bucket_size": 2000, "contiguous_gradients": True},
    {"stage": 1, "reduce_scatter": False, "offload_pin_host": False,
     "elastic_checkpoint": False, "allgather_partitions": False},
    True, False])
def test_zero_config_matches_jax(zero):
    cfg = {"train_batch_size": 4, "zero_optimization": zero, "allgather_size": 1234,
           "optimizer": {"type": "Adam", "params": {"lr": 1e-3}}}
    want = jconfig.DeepSpeedConfig(dict(cfg), world_size=1)
    got = tconfig.DeepSpeedConfig(dict(cfg), world_size=1)
    assert got.zero_config.repr() == want.zero_config.repr()
    assert (got.zero_enabled, got.zero_optimization_stage) == \
        (want.zero_enabled, want.zero_optimization_stage)
    assert got.zero_allow_untested_optimizer is want.zero_allow_untested_optimizer is False


@pytest.mark.parametrize("zero", [
    {"stage": 2, "offload_stream_buckets": 0, "cpu_offload": True},
    {"stage": 2, "offload_stream_buckets": 2.0, "cpu_offload": True},
    {"stage": 2, "offload_stream_buckets": True, "cpu_offload": True},
    {"stage": 2, "offload_pin_host": 1, "cpu_offload": True},
    {"stage": 1, "offload_stream_buckets": 4},
    {"stage": 2, "reduce_bucket_size": 0},
    {"stage": 2, "allgather_bucket_size": "big"},
    {"stage": 2, "overlap_comm": "yes"}])
def test_zero_config_errors_match_jax(zero):
    cfg = {"train_batch_size": 4, "zero_optimization": zero}
    with pytest.raises(jconfig.DeepSpeedConfigError):
        jconfig.DeepSpeedConfig(dict(cfg), world_size=1)
    with pytest.raises(tconfig.DeepSpeedConfigError):
        tconfig.DeepSpeedConfig(dict(cfg), world_size=1)


@pytest.mark.parametrize("kw", [
    dict(stage=0, dp=1), dict(stage=1, dp=8), dict(stage=2, dp=64), dict(stage=3, dp=8),
    dict(stage=2, dp=4, compute_bytes=4), dict(stage=2, dp=1, cpu_offload=True),
    dict(stage=1, dp=8, cpu_offload=True, offload_stream_buckets=4),
    dict(stage=2, dp=1, cpu_offload=True, offload_stream_buckets=3, compute_bytes=4)])
def test_mem_estimator_equals_jax(kw):
    n = 336_232_258
    assert tmem.estimate_zero_model_states_mem_needs(n, **kw) == \
        jmem.estimate_zero_model_states_mem_needs(n, **kw)
    assert tmem.mem_needs_report(n) == jmem.mem_needs_report(n)
    assert tmem.estimate_zero2_model_states_mem_needs(n, dp=2, cpu_offload=True) == \
        jmem.estimate_zero2_model_states_mem_needs(n, dp=2, cpu_offload=True)
    for bad in (dict(stage=4), dict(stage=3, cpu_offload=True), dict(dp=0),
                dict(cpu_offload=True, offload_stream_buckets=0)):
        with pytest.raises(ValueError):
            tmem.estimate_zero_model_states_mem_needs(n, **bad)


# ---------------------------------------------------------------------------
# the engine: stages 1-3 against stage 0
# ---------------------------------------------------------------------------

def _config(stage, dtype="bf16", clip=0.0, **kw):
    cfg = {"train_batch_size": 4, dtype: {"enabled": True},
           "optimizer": {"type": "Adam", "params": {"lr": 1e-3, "weight_decay": 0.01}},
           "zero_optimization": {"stage": stage}, "gradient_clipping": clip,
           "activation_checkpointing": {"enabled": True}}
    if dtype == "fp16":
        cfg["fp16"].update(initial_scale_power=10, hysteresis=1)
    cfg.update(kw)
    return cfg


def _dropout_bert(jcfg, params):
    model = BertForPreTraining.from_jax_params(
        _TO_NP(params), _tcfg(jcfg, hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1))
    return model


def _run(model, config, steps=3):
    engine, opt, _, _ = dt.initialize(model=model, config=config, device="cpu")
    batch = tuple(torch.from_numpy(x) for x in _bert_batch(4, SEQ, 256, 2))
    losses = [float(engine.train_step([batch])) for _ in range(steps)]
    return engine, opt, losses


@pytest.mark.parametrize("dtype", ["bf16", "fp16"])
@pytest.mark.parametrize("clip", [0.0, 1.0])
def test_zero_stages_equal_stage0_bit_for_bit(bert, dtype, clip):
    """Stages 1, 2 and 3 at world 1 give stage 0's losses, masters and
    module weights bit for bit, with dropout 0.1 and recompute on."""
    jcfg, params = bert
    base, _, want = _run(_dropout_bert(jcfg, params), _config(0, dtype, clip))
    want_master = base.master_params()
    want_weights = dict(base.module.named_parameters())
    for stage in (1, 2, 3):
        engine, opt, got = _run(_dropout_bert(jcfg, params), _config(stage, dtype, clip))
        assert isinstance(opt, ZeroShardedOptimizer) and opt.stage == stage
        assert got == want, (stage, got, want)
        assert engine.skipped_steps == base.skipped_steps
        for name, m in engine.master_params().items():
            assert torch.equal(m, want_master[name]), (stage, name)
        for name, p in engine.module.named_parameters():
            assert p.dtype == base.compute_dtype
            assert torch.equal(p.detach(), want_weights[name].detach()), (stage, name)
        assert float(engine.last_grad_norm) == float(base.last_grad_norm)


def test_zero2_parameters_alias_one_flat_buffer(bert):
    jcfg, params = bert
    engine, opt, _ = _run(_dropout_bert(jcfg, params), _config(2), steps=1)
    flat = opt._flat_param
    assert flat.dtype == torch.bfloat16 and flat.numel() % ALIGN == 0
    for p, off in zip(engine._params, opt._offsets):
        assert p.data_ptr() == flat.data_ptr() + off * flat.element_size()
        assert off % ALIGN == 0
    assert not hasattr(engine, "_master") or engine._master is None


def test_zero3_sharded_init_equals_init_bert():
    """At world 1 every parameter is its own whole shard: the values a
    whole ``init_bert(seed)`` draws, one leaf at a time from the meta
    device."""
    cfg = _tcfg(_jcfg())
    want = dt.init_bert(cfg, seed=5, device="cpu")
    got = dt.zero3_sharded_init(lambda: BertForPreTraining(cfg), bert_init_plan, seed=5,
                                device="cpu")
    for (name, p), (_, q) in zip(got.named_parameters(), want.named_parameters()):
        assert p.device.type == "cpu" and torch.equal(p, q), name
        assert p.ds_shape == tuple(q.shape)
    engine, _, losses = _run(got, _config(3))
    assert losses[-1] < losses[0]


def test_zero_lamb_is_not_the_per_tensor_lamb(bert):
    """The flat trust ratio is what makes stage 2 LAMB differ from stage 0
    LAMB (the JAX package's behaviour): the trajectories part."""
    jcfg, params = bert
    cfg = lambda stage: dict(_config(stage, dtype="bf16"),
                             optimizer={"type": "Lamb", "params": {"lr": 1e-2}})
    _, _, stage0 = _run(_dropout_bert(jcfg, params), cfg(0), steps=3)
    _, _, stage2 = _run(_dropout_bert(jcfg, params), cfg(2), steps=3)
    assert stage0[0] == stage2[0] and stage0[1:] != stage2[1:]


# ---------------------------------------------------------------------------
# what initialize() accepts and refuses
# ---------------------------------------------------------------------------

class _Quadratic(torch.nn.Module):
    def __init__(self):
        super().__init__()
        torch.manual_seed(0)
        self.lin = torch.nn.Linear(3, 2)

    def forward(self, x):
        return (self.lin(x) ** 2).mean()


@pytest.mark.parametrize("zero,opt", [
    ({"stage": 1}, "Adam"), ({"stage": 2}, "AdamW"), ({"stage": 3}, "Lamb"),
    ({"stage": 1, "cpu_offload": True}, "Adam"),
    ({"stage": 2, "cpu_offload": True, "offload_stream_buckets": 2}, "AdamW")])
def test_initialize_accepts_zero_stages_and_offload(zero, opt):
    cfg = {"train_batch_size": 2, "zero_optimization": zero,
           "optimizer": {"type": opt, "params": {"lr": 1e-2}}}
    engine, optimizer, _, _ = dt.initialize(model=_Quadratic(), config=cfg, device="cpu")
    assert isinstance(optimizer, ZeroShardedOptimizer)
    assert engine.zero_optimization() and engine.zero_optimization_stage() == zero["stage"]
    assert engine.zero_cpu_offload() == zero.get("cpu_offload", False)
    want = "DeepSpeedCPUAdam" if zero.get("cpu_offload") else {
        "Lamb": "FusedLamb"}.get(opt, "FusedAdam")
    assert type(engine.basic_optimizer).__name__ == want
    x = torch.ones(2, 3)
    losses = [float(engine.train_step([(x,)])) for _ in range(3)]
    assert losses[-1] < losses[0]


def test_cpu_offload_at_stage0_runs_the_device_adam_as_jax_does(bert):
    """At stage 0 ``cpu_offload`` only picks ``DeepSpeedCPUAdam``, whose
    device path is ``FusedAdam``'s (the JAX engine does the same): the
    run equals plain Adam's bit for bit."""
    jcfg, params = bert
    want_engine, _, want = _run(_dropout_bert(jcfg, params), _config(0))
    cfg = _config(0)
    cfg["zero_optimization"]["cpu_offload"] = True
    engine, opt, got = _run(_dropout_bert(jcfg, params), cfg)
    assert type(opt).__name__ == "DeepSpeedCPUAdam" and got == want
    for name, m in engine.master_params().items():
        assert torch.equal(m, want_engine.master_params()[name]), name
    jcfg_ = jconfig.DeepSpeedConfig(dict(cfg), world_size=1)
    assert jcfg_.zero_config.cpu_offload and not jcfg_.zero_enabled


def test_zero_refuses_an_untested_optimizer_as_jax_does():
    cfg = {"train_batch_size": 2, "zero_optimization": {"stage": 2},
           "optimizer": {"type": "SGD", "params": {"lr": 0.1}}}
    with pytest.raises(AssertionError, match="untested ZeRO Optimizer"):
        dt.initialize(model=_Quadratic(), config=cfg, device="cpu")
    engine, _, _, _ = dt.initialize(model=_Quadratic(), device="cpu",
                                    config=dict(cfg, zero_allow_untested_optimizer=True))
    assert type(engine.basic_optimizer).__name__ == "SGD"
