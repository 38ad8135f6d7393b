"""ZeRO-Offload of the port on the CPU: the host Adam kernel and the
offload engine, held against their plain version, each other and the
JAX package.

The kernel (``deepspeed_tpu_torch/csrc/cpu_adam.cpp``) is built here with
``g++`` at first use. Tolerances:

- the kernel against ``cpu_adam_reference``: bit for bit (the kernel is
  built with ``-ffp-contract=off`` and the plain version rounds each
  operation on its own in the kernel's order);
- sliced against whole steps, out of place against in place, the fused
  bf16 cast against ``.to(torch.bfloat16)``, streamed against sequential
  offload: bit for bit;
- the kernel against the JAX package's ``DeepSpeedCPUAdam.step_host``
  (its library is built without ``-ffp-contract=off``, so a multiply and
  an add may fuse): 2e-6 relative to each parameter's magnitude after
  five steps;
- the offload engine against the JAX engine's offload on tiny BERT:
  losses 2e-3 relative in bf16 and 1e-4 in fp16 (as for ZeRO without
  offload in test_torch_zero.py), with the overflow skips, loss scale and
  LR exactly.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import deepspeed_tpu  # noqa: E402
import deepspeed_tpu_torch as dt  # noqa: E402
from __graft_entry__ import _bert_batch, _tiny_bert_config  # noqa: E402
from deepspeed_tpu.models.bert import BertForPreTraining as JBert  # noqa: E402
from deepspeed_tpu.ops.adam.cpu_adam import DeepSpeedCPUAdam as JCPUAdam  # noqa: E402
from deepspeed_tpu_torch.kernels import build  # noqa: E402
from deepspeed_tpu_torch.models.bert import BertConfig, BertForPreTraining  # noqa: E402
from deepspeed_tpu_torch.ops.adam.cpu_adam import (  # noqa: E402
    DeepSpeedCPUAdam,
    cpu_adam_reference,
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
# the host kernel
# ---------------------------------------------------------------------------

HPARAMS = [dict(adam_w_mode=True, bias_correction=True, weight_decay=0.01),
           dict(adam_w_mode=False, bias_correction=True, weight_decay=0.1),
           dict(adam_w_mode=True, bias_correction=False, weight_decay=0.0),
           dict(adam_w_mode=False, bias_correction=False, weight_decay=0.0)]


def _vectors(n, seed):
    rng = np.random.RandomState(seed)
    return (torch.from_numpy(rng.randn(n).astype(np.float32)),
            [torch.from_numpy((rng.randn(n) * 10.0 ** rng.randint(-4, 2)).astype(np.float32))
             for _ in range(5)])


@pytest.mark.parametrize("hp", HPARAMS)
@pytest.mark.parametrize("n", [1, 37, 100_003])
def test_host_kernel_equals_plain_version_bit_for_bit(hp, n):
    p0, grads = _vectors(n, n)
    opt = DeepSpeedCPUAdam(lr=3e-3, betas=(0.9, 0.98), eps=1e-6, **hp)
    master = p0.clone()
    opt.init_host(master)
    ref, m, v = p0.clone(), torch.zeros(n), torch.zeros(n)
    for step, g in enumerate(grads, 1):
        opt.step_host(master, g)
        cpu_adam_reference(ref, g, m, v, lr=3e-3, beta1=0.9, beta2=0.98, eps=1e-6,
                           weight_decay=hp["weight_decay"], adamw=hp["adam_w_mode"],
                           step=step, bias_correction=hp["bias_correction"])
        assert torch.equal(master, ref), step
        assert torch.equal(opt._host_state.exp_avg, m)
        assert torch.equal(opt._host_state.exp_avg_sq, v)


@pytest.mark.parametrize("hp", HPARAMS[:2])
def test_host_kernel_matches_jax_step_host(hp):
    n = 4099
    p0, grads = _vectors(n, 7)
    topt = DeepSpeedCPUAdam(lr=1e-2, **hp)
    jopt = JCPUAdam(lr=1e-2, **hp)
    tm, jm = p0.clone(), p0.numpy().copy()
    topt.init_host(tm)
    jopt.init_host(jm)
    for g in grads:
        topt.step_host(tm, g)
        jopt.step_host(jm, g.numpy().copy())
    np.testing.assert_allclose(tm.numpy(), jm, rtol=2e-6, atol=2e-6)
    assert topt._host_state.step == jopt._host_state.step == 5


def test_sliced_steps_and_out_of_place_equal_the_whole_in_place_step():
    n = 10_007
    p0, grads = _vectors(n, 3)
    cuts = [0, 1, 64, 4000, 4001, 9000, n]
    whole, sliced, out = (DeepSpeedCPUAdam(lr=1e-2, weight_decay=0.01) for _ in range(3))
    mw, ms, mo = p0.clone(), p0.clone(), p0.clone()
    for opt, m in ((whole, mw), (sliced, ms), (out, mo)):
        opt.init_host(m)
    for g in grads:
        whole.step_host(mw, g)
        for i, (lo, hi) in enumerate(zip(cuts, cuts[1:])):
            sliced.step_host(ms, g[lo:hi].clone() if i % 2 else g, lo=lo, hi=hi,
                             advance_step=i == 0)
        dst = torch.full_like(mo, float("nan"))
        before = mo.clone()
        for i, (lo, hi) in enumerate(zip(cuts, cuts[1:])):
            out.step_host(mo, g, lo=lo, hi=hi, advance_step=i == 0, master_out=dst)
        assert torch.equal(mo, before)          # the source is left as it was
        mo = dst
        assert torch.equal(ms, mw) and torch.equal(mo, mw)
    for opt in (sliced, out):
        assert torch.equal(opt._host_state.exp_avg, whole._host_state.exp_avg)
        assert torch.equal(opt._host_state.exp_avg_sq, whole._host_state.exp_avg_sq)
        assert opt._host_state.step == whole._host_state.step == 5


def test_fused_bf16_cast_equals_torch_cast_bit_for_bit():
    rng = np.random.RandomState(11)
    n = 20_000
    p0 = (rng.randn(n) * 10.0 ** rng.randint(-40, 38, n)).astype(np.float32)
    # values a hair from bf16 ties, fp32's largest, infinities, signed zeros
    ties = (np.arange(1, 2001, dtype=np.uint32) << 16 | 0x8000).view(np.float32)
    p0[:2000] = ties
    p0[2000:2006] = [np.inf, -np.inf, 3.4e38, -3.4e38, 0.0, -0.0]
    master = torch.from_numpy(p0)
    opt = DeepSpeedCPUAdam(lr=0.0)            # lr 0: the step leaves p as it was
    opt.init_host(master)
    staged = torch.empty(n, dtype=torch.bfloat16)
    opt.step_host(master, torch.zeros(n), out_bf16=staged)
    assert torch.equal(master, torch.from_numpy(p0))
    assert torch.equal(staged.view(torch.int16), master.to(torch.bfloat16).view(torch.int16))
    opt = DeepSpeedCPUAdam(lr=1e-2)
    m = torch.from_numpy(rng.randn(n).astype(np.float32))
    opt.init_host(m)
    opt.step_host(m, torch.from_numpy(rng.randn(n).astype(np.float32)), out_bf16=staged)
    assert torch.equal(staged.view(torch.int16), m.to(torch.bfloat16).view(torch.int16))


def test_host_build_raises_without_a_compiler(monkeypatch):
    """No fallback: without g++ the kernel cannot be built, and that
    raises (a new flag set, so no earlier build is found)."""
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    with pytest.raises(build.KernelBuildError, match="g\\+\\+ not found"):
        build.build_host(build.HOST_FLAGS + ("-DDS_UNBUILT",))
    path = build.build_host()   # the default build exists from the tests above
    assert path.parent == build.BUILD_DIR and path.name.startswith("libdstorch_host_")


def test_no_decay_names_refused_under_offload_as_jax_does():
    for cls in (JCPUAdam, DeepSpeedCPUAdam):
        with pytest.raises(ValueError, match="no_decay_names"):
            cls(lr=1e-3, no_decay_names=["bias"])
    cfg = {"train_batch_size": 4, "zero_optimization": {"stage": 2, "cpu_offload": True},
           "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "no_decay_names": ["bias"]}}}
    with pytest.raises(ValueError, match="no_decay_names"):
        dt.initialize(model=_tiny_model(), config=cfg, device="cpu")


# ---------------------------------------------------------------------------
# the offload engine
# ---------------------------------------------------------------------------

def _tiny_model(jcfg=None, params=None, dropout=0.1):
    if params is not None:
        return BertForPreTraining.from_jax_params(
            _TO_NP(params), _tcfg(jcfg, hidden_dropout_prob=dropout,
                                  attention_probs_dropout_prob=dropout))
    return dt.init_bert(_tcfg(_jcfg(), hidden_dropout_prob=dropout,
                              attention_probs_dropout_prob=dropout), seed=0, device="cpu")


def _offload_config(dtype="bf16", K=1, pin=True, **kw):
    cfg = {"train_batch_size": 4, "gradient_clipping": 1.0,
           "optimizer": {"type": "Adam", "params": {"lr": 1e-3, "weight_decay": 0.01}},
           "zero_optimization": {"stage": 2, "cpu_offload": True,
                                 "offload_stream_buckets": K, "offload_pin_host": pin},
           "activation_checkpointing": {"enabled": True}}
    if dtype != "fp32":
        cfg[dtype] = {"enabled": True}
    cfg.update(kw)
    return cfg


def _offload_run(bert, config, steps=4):
    jcfg, params = bert
    engine, opt, _, _ = dt.initialize(model=_tiny_model(jcfg, params), config=config,
                                      device="cpu")
    batch = tuple(torch.from_numpy(x) for x in _bert_batch(4, SEQ, 256, 2))
    losses, masters = [], []
    for _ in range(steps):
        losses.append(float(engine.train_step([batch])))
        masters.append(opt._host_master)
    weights = {n: p.detach().clone() for n, p in engine.module.named_parameters()}
    return engine, opt, losses, engine.master_params(), weights, masters


@pytest.fixture(scope="module", params=["bf16", "fp32"])
def sequential(request, bert):
    return request.param, _offload_run(bert, _offload_config(request.param, K=1))


@pytest.mark.parametrize("K", [1, 2, 4])
@pytest.mark.parametrize("pin", [True, False])
def test_streamed_offload_equals_sequential_bit_for_bit(bert, sequential, K, pin):
    dtype, (_, _, want, want_master, want_weights, _) = sequential
    engine, opt, got, master, weights, masters = _offload_run(
        bert, _offload_config(dtype, K=K, pin=pin))
    assert got == want
    for name, m in master.items():
        assert torch.equal(m, want_master[name]), name
    for name, w in weights.items():
        assert torch.equal(w, want_weights[name]), name
    stats = opt.last_offload_stats
    assert set(stats) == {"buckets", "d2h_ms", "host_step_ms", "h2d_ms", "wall_ms",
                          "overlap_frac"}
    assert 0.0 <= stats["overlap_frac"] <= 1.0
    assert (stats["buckets"] > 1) == (K > 1)
    if K > 1:
        # the ping-pong pair: kept and alternated under offload_pin_host,
        # a fresh partner every step without it
        ptrs = [m.data_ptr() for m in masters]
        if pin:
            assert ptrs[0] == ptrs[2] and ptrs[1] == ptrs[3] and ptrs[0] != ptrs[1]
        assert {t.__class__ for t in opt._grad_slots} == {torch.Tensor}
        assert len(opt._grad_slots) == 2


def test_offload_worker_error_is_raised_on_the_training_thread(bert, monkeypatch):
    engine, opt, _, _, _, _ = _offload_run(bert, _offload_config(K=4), steps=1)
    before = opt._host_master.clone()
    calls = []
    step_host = opt.inner.step_host

    def failing(*args, **kw):
        calls.append(kw.get("lo"))
        if len(calls) == 2:
            raise RuntimeError("host step failed")
        return step_host(*args, **kw)

    monkeypatch.setattr(opt.inner, "step_host", failing)
    batch = tuple(torch.from_numpy(x) for x in _bert_batch(4, SEQ, 256, 2))
    with pytest.raises(RuntimeError, match="host step failed"):
        engine.train_step([batch])
    assert torch.equal(opt._host_master, before)   # the out-of-place step left it
    assert all(t.name in ("zero-offload-adam", "zero-offload-h2d")
               for t in opt._offload_threads)


def test_fp16_overflow_skips_the_host_step(bert):
    """From a loss scale of 2^24 the first steps overflow: the host master,
    the host Adam state and the module weights stay as they were, the
    scale halves, and the first clean step then moves them."""
    config = _offload_config("fp16", K=2, optimizer={"type": "Adam",
                                                    "params": {"lr": 1e-3}})
    config["fp16"].update(initial_scale_power=24, hysteresis=1)
    jcfg, params = bert
    engine, opt, _, _ = dt.initialize(model=_tiny_model(jcfg, params), config=config,
                                      device="cpu")
    batch = tuple(torch.from_numpy(x) for x in _bert_batch(4, SEQ, 256, 2))
    master = opt._host_master.clone()
    weights = [p.detach().clone() for p in engine._params]
    engine.train_step([batch])
    assert engine.skipped_steps == 1 and engine.loss_scale() == 2.0 ** 23
    assert float(engine.last_grad_norm) == -1.0
    assert torch.equal(opt._host_master, master) and opt._host_inner.step == 0
    assert all(torch.equal(p, w) for p, w in zip(engine._params, weights))
    while engine.skipped_steps == engine.global_steps:
        engine.train_step([batch])
    assert opt._host_inner.step == 1 and not torch.equal(opt._host_master, master)


def test_stage3_offload_refused_as_jax_does(bert):
    cfg = _offload_config("fp32")
    cfg["zero_optimization"]["stage"] = 3
    with pytest.raises(AssertionError, match="ZeRO-3 \\+ cpu_offload"):
        dt.initialize(model=_tiny_model(), config=cfg, device="cpu")
    jcfg, params = bert
    with pytest.raises(AssertionError, match="ZeRO-3 \\+ cpu_offload"):
        jeng, _, _, _ = deepspeed_tpu.initialize(
            model=JBert(jcfg), model_parameters=params,
            config_params=dict(cfg, mesh={"data_parallel_size": 1}))
        jeng.train_batch(iter([tuple(jnp.asarray(x) for x in _bert_batch(4, SEQ, 256, 2))]))


@pytest.mark.parametrize("opt", [{"type": "Lamb", "params": {"lr": 1e-3}},
                                 {"type": "SGD", "params": {"lr": 1e-3}}])
def test_offload_without_a_host_step_names_the_cause(bert, opt):
    """The JAX engine builds such an engine and fails at its first step
    (its inner optimizer has no ``step_host``); the port refuses it when
    the engine is built, naming the cause."""
    cfg = _offload_config("fp32", optimizer=opt, zero_allow_untested_optimizer=True)
    with pytest.raises(TypeError, match="no host step \\(step_host\\)"):
        dt.initialize(model=_tiny_model(), config=cfg, device="cpu")
    jcfg, params = bert
    jeng, _, _, _ = deepspeed_tpu.initialize(
        model=JBert(jcfg), model_parameters=params,
        config_params=dict(cfg, mesh={"data_parallel_size": 1}))
    with pytest.raises(AttributeError, match="step_host"):
        jeng.train_batch(iter([tuple(jnp.asarray(x) for x in _bert_batch(4, SEQ, 256, 2))]))


def _data(n, seed):
    cols = _bert_batch(n, SEQ, 256, seed)
    return [tuple(c[i] for c in cols) for i in range(n)]


@pytest.mark.parametrize("dtype,K,rtol", [("bf16", 1, 2e-3), ("bf16", 4, 2e-3),
                                          ("fp16", 2, 1e-4)])
def test_offload_trajectory_matches_jax_offload(bert, dtype, K, rtol):
    config = _offload_config(dtype, K=K)
    if dtype == "fp16":
        config["fp16"].update(initial_scale_power=20, hysteresis=1, loss_scale_window=3)
    jcfg, params = bert
    data = _data(8, seed=3)
    jeng, _, _, _ = deepspeed_tpu.initialize(
        model=JBert(_jcfg()), model_parameters=jax.tree_util.tree_map(jnp.array, params),
        config_params=dict(config, mesh={"data_parallel_size": 1}), training_data=data)
    teng, _, _, _ = dt.initialize(model=_tiny_model(jcfg, params, dropout=0.0),
                                  config=config, training_data=data, device="cpu")
    runs = []
    for eng in (jeng, teng):
        runs.append([(eng.train_batch(), eng.loss_scale(), eng.skipped_steps, eng.get_lr()[0])
                     for _ in range(8)])
    want, got = runs
    np.testing.assert_allclose([r[0] for r in got], [r[0] for r in want], rtol=rtol)
    assert [r[1:] for r in got] == [r[1:] for r in want]
    assert got[-1][0] < got[0][0]
