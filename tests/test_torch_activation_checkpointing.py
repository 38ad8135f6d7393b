"""Activation checkpointing of the port against the JAX package's, on the CPU.

``deepspeed_tpu_torch.checkpointing`` mirrors
``tests/unit/test_activation_checkpointing.py``: ``checkpoint()`` against
the plain call (bit for bit) and against JAX's ``checkpoint()`` on the
same function and weights (fp32: the loss to 1e-6 relative, the gradient
to 1e-6 of its largest magnitude, the repo's convention for a gradient),
the RNG tracker's replay, errors and seeds, ``configure()``'s module state beside JAX's, ``offload_dots``
gradients bit for bit those of ``dots``, and the engine's wiring: the
model switch and its policy flipped, or the whole forward recomputed under
the offload policy; a 2-layer BERT under ``cpu_checkpointing`` against
the JAX engine's losses (1e-5 relative over 3 steps, dropout off).
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
from deepspeed_tpu.runtime.activation_checkpointing import checkpointing as jckpt  # noqa: E402
from deepspeed_tpu_torch.models.bert import BertConfig, BertForPreTraining  # noqa: E402
from deepspeed_tpu_torch.runtime.activation_checkpointing import (  # noqa: E402
    checkpointing as tckpt,
)

SEQ = 128   # the flash kernels' block: the attention runs their plain versions
_STATE = ("_CONFIG", "_MPU", "_NUM_LAYERS", "_PARTITION_ACTIVATIONS", "_CPU_CHECKPOINT",
          "_CONTIGUOUS_CHECKPOINTING", "_SYNCHRONIZE", "_PROFILE_TIME")


@pytest.fixture(autouse=True)
def _fresh_state():
    """Both modules start unconfigured and are left as they were found."""
    saved = {m: {k: getattr(m, k) for k in _STATE} for m in (jckpt, tckpt)}
    for m in (jckpt, tckpt):
        m._CONFIG = m._MPU = m._NUM_LAYERS = None
        m._PARTITION_ACTIVATIONS = m._CPU_CHECKPOINT = m._CONTIGUOUS_CHECKPOINTING = False
        m._SYNCHRONIZE = m._PROFILE_TIME = False
    yield
    for m, state in saved.items():
        for k, v in state.items():
            setattr(m, k, v)


def _state(m):
    out = {k: getattr(m, k) for k in _STATE if k not in ("_CONFIG", "_MPU")}
    out["_CONFIG"] = None if m._CONFIG is None else vars(m._CONFIG)
    return out


# ---------------------------------------------------------------------------
# checkpoint()
# ---------------------------------------------------------------------------

def _block_np():
    w = np.random.RandomState(0).randn(16, 16).astype(np.float32) * 0.3
    x = np.random.RandomState(1).randn(4, 16).astype(np.float32)
    return x, w


@pytest.mark.parametrize("cpu_checkpointing", [False, True])
def test_checkpoint_equals_plain_and_jax(cpu_checkpointing):
    x, w = _block_np()
    tckpt.configure(None, checkpoint_in_cpu=cpu_checkpointing)
    jckpt.configure(None, checkpoint_in_cpu=cpu_checkpointing)

    def block(x, w):
        return torch.tanh(x @ w) @ w.T

    def run(ckpt):
        tw = torch.from_numpy(w).requires_grad_()
        out = tckpt.checkpoint(block, torch.from_numpy(x), tw) if ckpt else \
            block(torch.from_numpy(x), tw)
        loss = (out ** 2).sum()
        loss.backward()
        return loss.detach(), tw.grad

    l_plain, g_plain = run(False)
    l_ckpt, g_ckpt = run(True)
    assert torch.equal(l_ckpt, l_plain) and torch.equal(g_ckpt, g_plain)

    def jloss(w):
        return jnp.sum(jckpt.checkpoint(lambda x, w: jnp.tanh(x @ w) @ w.T,
                                        jnp.asarray(x), w) ** 2)

    jl, jg = jax.value_and_grad(jloss)(jnp.asarray(w))
    np.testing.assert_allclose(float(l_ckpt), float(jl), rtol=1e-6)
    jg = np.asarray(jg)
    np.testing.assert_allclose(g_ckpt.numpy(), jg, rtol=0, atol=1e-6 * np.abs(jg).max())


def test_checkpoint_wrapper_profile_and_synchronize():
    tckpt.configure(None, profile=True, synchronize=True)
    x, w = _block_np()
    f = tckpt.checkpoint_wrapper(lambda x, w: torch.tanh(x @ w))
    tw = torch.from_numpy(w).requires_grad_()
    f(torch.from_numpy(x), tw).sum().backward()
    want = torch.from_numpy(w).requires_grad_()
    torch.tanh(torch.from_numpy(x) @ want).sum().backward()
    assert torch.equal(tw.grad, want.grad)
    out = tckpt.checkpoint(lambda x: torch.tanh(x), torch.from_numpy(x).requires_grad_())
    assert out.shape == (4, 16)


def _masked(x, seed):
    """Dropout-like: keep elements by a mask drawn from ``seed``."""
    gen = torch.Generator().manual_seed(int(seed))
    keep = torch.rand(x.shape, generator=gen) < 0.5
    return torch.where(keep, torch.tanh(x) * 2.0, torch.zeros_like(x))


def test_rng_replay_through_the_tracker():
    """A Megatron-style call: the dropout seed is forked before the
    checkpointed call, which replays it in the recompute; a function that
    forks inside the region (the planted fault) draws a fresh seed in the
    recompute and its gradient differs."""
    tracker = tckpt.get_cuda_rng_tracker()
    x0 = torch.from_numpy(np.random.RandomState(2).randn(8, 32).astype(np.float32))

    def grad_of(fn, ckpt):
        tracker.reset()
        tracker.add("drop", 123)
        x = x0.clone().requires_grad_()
        if ckpt:
            out = tckpt.checkpoint(fn, x)
        else:
            out = fn(x)
        (out ** 2).sum().backward()
        return x.grad

    forked = lambda x, seed=None: _masked(x, tracker.fork("drop") if seed is None else seed)
    outside = []

    def replayed(x):
        return _masked(x, outside[-1])

    tracker.reset()
    tracker.add("drop", 123)
    outside.append(tracker.fork("drop"))
    want = x0.clone().requires_grad_()
    (_masked(want, outside[-1]) ** 2).sum().backward()
    got = x0.clone().requires_grad_()
    (tckpt.checkpoint(replayed, got) ** 2).sum().backward()
    assert torch.equal(got.grad, want.grad)
    # planted: forking inside the region draws another mask in the recompute
    assert not torch.equal(grad_of(forked, True), grad_of(forked, False))
    # the global generator is replayed for the recompute
    drop = lambda x: torch.nn.functional.dropout(x, 0.5) * 3.0
    torch.manual_seed(5)
    a = x0.clone().requires_grad_()
    (tckpt.checkpoint(drop, a) ** 2).sum().backward()
    torch.manual_seed(5)
    b = x0.clone().requires_grad_()
    (drop(b) ** 2).sum().backward()
    assert torch.equal(a.grad, b.grad)


def test_tracker_errors_and_fork_determinism():
    t1, t2 = tckpt.RNGStatesTracker(), tckpt.RNGStatesTracker()
    t1.add("a", 7)
    t2.add("a", 7)
    s1 = [t1.fork("a") for _ in range(4)]
    assert s1 == [t2.fork("a") for _ in range(4)]
    assert len(set(s1)) == 4 and all(isinstance(s, int) and s >= 0 for s in s1)
    states = t1.get_states()
    nxt = t1.fork("a")
    t1.set_states(states)
    assert t1.fork("a") == nxt
    for tracker in (t1, jckpt.RNGStatesTracker()):
        tracker.add("b", 1)
        with pytest.raises(Exception, match="seed b already exists"):
            tracker.add("b", 2)
        with pytest.raises(Exception, match="rng state c is not added"):
            tracker.fork("c")
    t1.reset()
    assert t1.get_states() == ({}, {})


def test_model_parallel_seed_is_seed_plus_2718_plus_mp_rank():
    class Mpu:
        def get_model_parallel_rank(self):
            return 1

    for m in (tckpt, jckpt):
        m.configure(Mpu())
        m.model_parallel_cuda_manual_seed(7)
    name = tckpt._MODEL_PARALLEL_RNG_TRACKER_NAME
    assert name == jckpt._MODEL_PARALLEL_RNG_TRACKER_NAME
    assert tckpt.get_cuda_rng_tracker().states_[name] == 7 + 2718 + 1
    np.testing.assert_array_equal(np.asarray(jckpt.get_cuda_rng_tracker().states_[name]),
                                  np.asarray(jax.random.PRNGKey(7 + 2718 + 1)))
    tckpt.configure(None)
    assert tckpt.model_parallel_cuda_manual_seed(3) == 3
    assert tckpt.get_cuda_rng_tracker().states_[name] == 3 + 2718


# ---------------------------------------------------------------------------
# configure()
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("how", ["dict", "args", "both", "json"])
def test_configure_leaves_the_module_state_of_jax(how, tmp_path):
    section = {"activation_checkpointing": {
        "partition_activations": True, "number_checkpoints": 4,
        "contiguous_memory_optimization": True, "cpu_checkpointing": True,
        "synchronize_checkpoint_boundary": True, "profile": False}}
    kw = dict(partition_activations=True, contiguous_checkpointing=False,
              num_checkpoints=6, checkpoint_in_cpu=True, synchronize=False, profile=True)
    if how == "json":
        path = tmp_path / "ds.json"
        path.write_text(__import__("json").dumps(section))
        args = dict(deepspeed_config=str(path))
    else:
        args = dict(deepspeed_config=section if how in ("dict", "both") else None,
                    **(kw if how in ("args", "both") else {}))
    for m in (tckpt, jckpt):
        m.configure(None, **args)
    assert _state(tckpt) == _state(jckpt)
    assert tckpt.is_configured() and jckpt.is_configured()
    tckpt.reset()
    assert _state(tckpt) == _state(jckpt)
    tckpt.partition_activations_in_checkpoint(False)
    tckpt.set_num_layers(9)
    jckpt.partition_activations_in_checkpoint(False)
    jckpt.set_num_layers(9)
    assert _state(tckpt) == _state(jckpt)


def test_contiguous_without_partition_is_refused_as_in_jax():
    msgs = []
    for m in (tckpt, jckpt):
        with pytest.raises(Exception) as e:
            m.configure(None, partition_activations=False, contiguous_checkpointing=True,
                        num_checkpoints=2)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "Contiguous memory checkpointing" in msgs[0]
    for m in (tckpt, jckpt):
        m._NUM_LAYERS = None
        with pytest.raises(AssertionError, match="number of checkpoints"):
            m.configure(None, partition_activations=True, contiguous_checkpointing=True)


# ---------------------------------------------------------------------------
# offload_dots
# ---------------------------------------------------------------------------

def _jcfg(**kw):
    return dataclasses.replace(_tiny_bert_config(), max_position_embeddings=SEQ, **kw)


def _tcfg(jcfg, **kw):
    d = dataclasses.asdict(jcfg)
    d.pop("scan_unroll")
    d.update(kw)
    return BertConfig(**d)


def _batch(B, seed=0):
    return tuple(torch.from_numpy(x).long() for x in _bert_batch(B, SEQ, 256, seed))


def _bert_grads(policy, remat=True):
    """One forward and backward of tiny BERT with dropout 0.1 under
    ``policy``: the loss and every parameter's gradient."""
    cfg = _tcfg(_jcfg(hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1),
                checkpoint_activations=remat, checkpoint_policy=policy)
    model = dt.init_bert(cfg, seed=0, device="cpu")
    loss = model(*_batch(1, seed=3), dropout_seed=11)
    loss = loss[0] if isinstance(loss, tuple) else loss
    loss.backward()
    return loss.detach(), {n: p.grad for n, p in model.named_parameters()}


@pytest.fixture(scope="module")
def bert_runs():
    """Tiny BERT's loss and gradients with no checkpointing and under each
    policy, and the offload's counts."""
    runs = {"none": _bert_grads("nothing", remat=False)}
    for policy in ("nothing", "dots", "offload_dots"):
        tckpt.reset_offload_stats()
        runs[policy] = _bert_grads(policy)
        if policy == "offload_dots":
            runs["stats"] = tckpt.offload_stats()
    return runs


def test_offload_dots_gradients_equal_dots_bit_for_bit(bert_runs):
    """The four settings of the chip's phase, at tiny width: no
    checkpointing, ``nothing``, ``dots`` and ``offload_dots`` give the same
    loss and gradients bit for bit; the offload moves every matmul output
    of the layers out and back (4 a layer)."""
    ref_loss, ref = bert_runs["none"]
    stats = bert_runs["stats"]
    for policy in ("nothing", "dots", "offload_dots"):
        loss, grads = bert_runs[policy]
        assert torch.equal(loss, ref_loss), policy
        for n, g in ref.items():
            assert torch.equal(grads[n], g), (policy, n)
    cfg = _tiny_bert_config()
    rows = SEQ
    want = 4 * cfg.num_hidden_layers * rows * (3 * cfg.hidden_size + cfg.hidden_size
                                               + cfg.intermediate_size + cfg.hidden_size)
    assert stats["saved"] == 4 * cfg.num_hidden_layers
    assert stats["d2h_bytes"] == want
    assert stats["restored"] == stats["saved"] and stats["h2d_bytes"] == want


def test_offload_dots_planted_fault_shows(bert_runs):
    """A host copy zeroed between forward and backward must change the
    gradients (the check above can see a broken offload)."""
    real = tckpt._to_host

    def zeroed(t):
        host, done, device = real(t)
        return torch.zeros_like(host), done, device

    _, want = bert_runs["dots"]
    tckpt._to_host = zeroed
    try:
        _, got = _bert_grads("offload_dots")
    finally:
        tckpt._to_host = real
    assert any(not torch.equal(got[n], g) for n, g in want.items())


def test_offload_dots_second_backward_is_refused():
    x = torch.randn(4, 8, requires_grad=True)
    w = torch.randn(8, 8)
    out = tckpt.checkpoint_call(lambda x: torch.tanh(x @ w), x, policy="offload_dots")
    out.sum().backward(retain_graph=True)
    with pytest.raises(RuntimeError):
        out.sum().backward()


def test_policy_names_are_jax_s():
    assert tckpt.REMAT_POLICIES == jckpt.REMAT_POLICIES
    with pytest.raises(ValueError, match="checkpoint_policy"):
        tckpt.resolve_remat_policy("everything")
    assert dt.GPT2Config(checkpoint_policy="offload_dots").checkpoint_policy == "offload_dots"


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _ds_config(**ac):
    return {"train_batch_size": 4, "gradient_accumulation_steps": 1,
            "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
            "activation_checkpointing": {"enabled": True, **ac}}


class _Regression(torch.nn.Module):
    """A model with no per-layer switch."""

    def __init__(self):
        super().__init__()
        torch.manual_seed(0)
        self.a = torch.nn.Linear(8, 16)
        self.b = torch.nn.Linear(16, 1)

    def forward(self, x, y):
        return ((self.b(torch.tanh(self.a(x))) - y) ** 2).mean()


def test_engine_recomputes_the_whole_forward_under_the_offload_policy():
    rng = np.random.RandomState(0)
    data = [(torch.from_numpy(rng.randn(4, 8).astype(np.float32)),
             torch.from_numpy(rng.randn(4, 1).astype(np.float32))) for _ in range(3)]
    runs = {}
    for name, cfg in (("plain", {"train_batch_size": 4,
                                 "optimizer": {"type": "Adam", "params": {"lr": 1e-3}}}),
                      ("offload", _ds_config(cpu_checkpointing=True))):
        engine, _, _, _ = dt.initialize(model=_Regression(), config=cfg, device="cpu")
        tckpt.reset_offload_stats()
        runs[name] = ([float(engine.train_step([mb])) for mb in data], engine,
                      tckpt.offload_stats())
    engine = runs["offload"][1]
    assert engine._remat_module and engine._remat_fallback_policy == "offload_dots"
    assert tckpt._CPU_CHECKPOINT and tckpt._CONFIG.cpu_checkpointing
    assert runs["offload"][2]["saved"] == 2 * 3      # two addmm a step
    assert runs["plain"][2]["saved"] == 0
    assert runs["offload"][0] == runs["plain"][0]
    for n, m in runs["plain"][1].master_params().items():
        assert torch.equal(engine.master_params()[n], m), n


def test_engine_flips_the_model_switch_and_its_policy():
    cfg = _tcfg(_jcfg())
    assert not cfg.checkpoint_activations and cfg.checkpoint_policy == "nothing"
    engine, _, _, _ = dt.initialize(model=dt.init_bert(cfg, seed=0, device="cpu"),
                                    config=_ds_config(cpu_checkpointing=True), device="cpu")
    assert cfg.checkpoint_activations and cfg.checkpoint_policy == "offload_dots"
    assert not engine._remat_module
    cfg2 = _tcfg(_jcfg())
    dt.initialize(model=dt.init_bert(cfg2, seed=0, device="cpu"), config=_ds_config(),
                  device="cpu")
    assert cfg2.checkpoint_activations and cfg2.checkpoint_policy == "nothing"


def test_cpu_checkpointing_bert_matches_the_jax_engine():
    """Two-layer BERT with ``cpu_checkpointing``: the model's policy is
    ``offload_dots`` in both packages and the losses of 3 steps agree at
    1e-5 relative; every step moved the layers' matmul outputs."""
    jcfg = _jcfg()
    jmodel = JBert(jcfg)
    batch = _bert_batch(1, SEQ, 256, 1)
    params = jax.jit(jmodel.init)({"params": jax.random.PRNGKey(0),
                                   "dropout": jax.random.PRNGKey(1)},
                                  *(jnp.asarray(x) for x in batch))
    np_params = jax.tree_util.tree_map(np.asarray, params)
    cfg = dict(_ds_config(cpu_checkpointing=True), train_batch_size=1,
               mesh={"data_parallel_size": 1})
    jeng, _, _, _ = deepspeed_tpu.initialize(model=jmodel, model_parameters=params,
                                             config_params=cfg)
    assert jcfg.checkpoint_policy == "offload_dots"
    jb = tuple(jnp.asarray(x) for x in batch)
    want = [float(jeng.train_step([jb])) for _ in range(3)]
    tcfg = _tcfg(jcfg, checkpoint_activations=False, checkpoint_policy="nothing")
    teng, _, _, _ = dt.initialize(model=BertForPreTraining.from_jax_params(np_params, tcfg),
                                  config=dict(_ds_config(cpu_checkpointing=True),
                                              train_batch_size=1), device="cpu")
    assert tcfg.checkpoint_policy == "offload_dots"
    tckpt.reset_offload_stats()
    tb = tuple(torch.from_numpy(x) for x in batch)
    got = [float(teng.train_step([tb])) for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert tckpt.offload_stats()["saved"] == 3 * 4 * jcfg.num_hidden_layers


def test_top_level_checkpointing_export():
    assert dt.checkpointing is tckpt
    assert "checkpointing" in dt.__all__
    assert dt.checkpointing.get_cuda_rng_tracker() is tckpt._RNG_TRACKER


def test_pipeline_accepts_cpu_checkpointing_and_trains_as_without():
    """Under the interpreter (the port's one executor) the flag changes
    nothing, as under JAX's interpreted executor: the losses are bit for
    bit those of the same pipeline without it."""
    import test_torch_pipe as tp

    from deepspeed_tpu_torch.runtime.pipe.module import PipelineModule

    losses = {}
    for flag in (False, True):
        module = PipelineModule(tp._torch_layers(False), num_stages=2, loss_fn=tp.mse_loss,
                                partition_method="uniform")
        extra = {"activation_checkpointing": {"enabled": True, "cpu_checkpointing": flag}}
        engine, _, _, _ = dt.initialize(model=module, config_params=tp._config(extra),
                                        device="cpu")
        data = tp._torch_batches(tp._data(4))
        losses[flag] = [engine.train_batch(iter(data[:2])), engine.train_batch(iter(data[2:]))]
    assert losses[True] == losses[False]
