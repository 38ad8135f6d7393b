"""The port's fp16 training path, held against the JAX package on the CPU.

Loss scaling (``update_scaler`` and ``DynamicLossScaler`` step for step
over random overflow sequences, exactly), ``FP16_Optimizer`` on fixed
gradients, the layer and BERT in fp16 against flax, and whole engine
trajectories: fp16 with LAMB, ``WarmupDecayLR`` and dynamic loss scaling
over ``training_data=`` through ``train_batch()``, and bf16 with Adam.
Inputs come from numpy seeds and the same weights go to both packages
(``from_jax_params``). The attention runs the flash kernels' plain
versions (sequence 128, the kernel block); ``chip_smoke.py`` holds the
fp16 CUDA kernels against those on the card.

Tolerances: the scaler and its verdicts exact; optimizer steps 1e-6
relative (fp32 math in another order). fp16 layer and BERT: outputs and
the loss 1e-3 relative, gradients 2e-2 of each gradient's largest
magnitude (two fp16 layers of GEMMs and layer norms that round in
another order; measured up to 9.3e-3). Engine trajectories: fp16 losses
1e-4 relative (one fp16 forward each, measured 1.4e-5), bf16 losses 2e-3
relative (bf16 rounds eight times coarser, measured 3.2e-4); overflow
flags, loss scale, skipped steps and LR exactly.
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
from deepspeed_tpu.ops.adam.fused_adam import FusedAdam as JAdam  # noqa: E402
from deepspeed_tpu.ops.lamb.fused_lamb import FusedLamb as JLamb  # noqa: E402
from deepspeed_tpu.ops.sgd import SGD as JSGD  # noqa: E402
from deepspeed_tpu.ops.transformer.transformer import (  # noqa: E402
    DeepSpeedTransformerConfig as JLayerCfg,
    DeepSpeedTransformerLayer as JLayer,
)
from deepspeed_tpu.runtime.fp16 import fused_optimizer as jfo  # noqa: E402
from deepspeed_tpu.runtime.fp16 import loss_scaler as jls  # noqa: E402
from deepspeed_tpu_torch.models.bert import BertConfig, BertForPreTraining  # noqa: E402
from deepspeed_tpu_torch.ops.adam.fused_adam import FusedAdam  # noqa: E402
from deepspeed_tpu_torch.ops.lamb.fused_lamb import FusedLamb  # noqa: E402
from deepspeed_tpu_torch.ops.sgd import SGD  # noqa: E402
from deepspeed_tpu_torch.ops.transformer.transformer import (  # noqa: E402
    DeepSpeedTransformerConfig,
    DeepSpeedTransformerLayer,
)
from deepspeed_tpu_torch.runtime.fp16 import fused_optimizer as tfo  # noqa: E402
from deepspeed_tpu_torch.runtime.fp16 import loss_scaler as tls  # noqa: E402

SEQ = 128   # the kernels' block: the attention runs kernels 1-3's plain versions
_TO_NP = lambda tree: jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree)


def _close(got, want, tol):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = max(1e-3, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _jcfg():
    return dataclasses.replace(_tiny_bert_config(), max_position_embeddings=SEQ)


def _tcfg(jcfg):
    d = dataclasses.asdict(jcfg)
    d.pop("scan_unroll")
    return BertConfig(**d)


@pytest.fixture(scope="module")
def bert():
    jcfg = _jcfg()
    jmodel = JBert(jcfg)
    batch = _bert_batch(2, SEQ, 256, 0)
    params = jmodel.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                         *(jnp.asarray(x) for x in batch))
    return jcfg, jmodel, params, batch


# ---------------------------------------------------------------------------
# loss scaling
# ---------------------------------------------------------------------------

def _state_tuple(state):
    return tuple(float(np.asarray(x)) for x in state)


@pytest.mark.parametrize("consecutive", [False, True])
@pytest.mark.parametrize("delayed_shift,window", [(1, 5), (2, 3), (3, 1000)])
def test_update_scaler_matches_jax_step_for_step(delayed_shift, window, consecutive):
    rng = np.random.RandomState(delayed_shift * 10 + window + consecutive)
    flags = rng.rand(200) < 0.3
    flags[40:60] = False                       # a clean run long enough to grow
    kw = dict(scale_window=window, min_scale=4.0, delayed_shift=delayed_shift,
              consecutive_hysteresis=consecutive)
    js = jls.init_dynamic_scaler_state(init_scale=2.0 ** 16, delayed_shift=delayed_shift)
    ts = tls.init_dynamic_scaler_state(init_scale=2.0 ** 16, delayed_shift=delayed_shift)
    jhost = jls.DynamicLossScaler(init_scale=2.0 ** 16, scale_window=window, min_scale=4.0,
                                  delayed_shift=delayed_shift,
                                  consecutive_hysteresis=consecutive)
    thost = tls.DynamicLossScaler(init_scale=2.0 ** 16, scale_window=window, min_scale=4.0,
                                  delayed_shift=delayed_shift,
                                  consecutive_hysteresis=consecutive)
    seen = set()
    for i, flag in enumerate(flags):
        # the port takes the verdict as a device flag or a host bool
        js = jls.update_scaler(js, bool(flag), **kw)
        ts = tls.update_scaler(ts, torch.tensor(bool(flag)) if i % 2 else bool(flag), **kw)
        assert _state_tuple(ts) == _state_tuple(js), i
        assert ts.cur_scale.dtype == torch.float32 and ts.cur_iter.dtype == torch.int32
        jhost.update_scale(bool(flag))
        thost.update_scale(bool(flag))
        got = (thost.cur_scale, thost.cur_iter, thost.last_overflow_iter, thost.cur_hysteresis)
        assert got == (jhost.cur_scale, jhost.cur_iter, jhost.last_overflow_iter,
                       jhost.cur_hysteresis), i
        seen.add(float(ts.cur_scale))
    assert len(seen) > 3     # the sequence moved the scale both ways


def test_static_scaler_factory_and_host_checks():
    for args in (dict(dynamic_scaling=False, static_loss_scale=128.0),
                 dict(dynamic_scaling=True),
                 dict(dynamic_scaling=True, dynamic_loss_args={
                     "init_scale": 2.0 ** 10, "scale_window": 7, "delayed_shift": 3,
                     "min_scale": 2.0})):
        j, t = jls.CreateLossScaler(**args), tls.CreateLossScaler(**args)
        assert type(t).__name__ == type(j).__name__
        assert t.loss_scale == j.loss_scale
        for attr in ("scale_window", "delayed_shift", "min_scale"):
            assert getattr(t, attr, None) == getattr(j, attr, None)
    dyn = tls.DynamicLossScaler()
    finite = [torch.ones(3), torch.zeros(2, 2)]
    assert not dyn.has_overflow(finite)
    assert dyn.has_overflow(finite + [torch.tensor([1.0, float("inf")])])
    assert dyn.has_overflow([torch.tensor([float("nan")], dtype=torch.float16)])
    static = tls.LossScaler(scale=8.0)
    w = torch.tensor(3.0, requires_grad=True)
    scaled = static.backward(w * 2.0)
    assert float(scaled.detach()) == 48.0 and float(w.grad) == 16.0
    assert [float(g) for g in static.scale_gradient([torch.tensor(0.5)])] == [4.0]
    # static scaling only counts the iteration
    state = tls.init_dynamic_scaler_state(init_scale=8.0)
    state = tls.advance_scaler(state, True, dynamic=False)
    assert _state_tuple(state) == (8.0, 1.0, -1.0, 1.0)


_INNER = {
    "adam": (lambda: JAdam(lr=1e-2, weight_decay=0.01), lambda: FusedAdam(lr=1e-2,
                                                                          weight_decay=0.01)),
    "lamb": (lambda: JLamb(lr=1e-2, weight_decay=0.01), lambda: FusedLamb(lr=1e-2,
                                                                          weight_decay=0.01)),
    "sgd": (lambda: JSGD(lr=1e-1, momentum=0.9), lambda: SGD(lr=1e-1, momentum=0.9)),
}


@pytest.mark.parametrize("inner", list(_INNER))
def test_fp16_optimizer_step_matches_jax(inner):
    """Five steps of ``FP16_Optimizer`` on fixed fp16 gradients (scaled by
    the live loss scale), the third holding an inf: that step is skipped
    and the scale backs off on both sides; the others unscale, clip and
    step the fp32 masters identically."""
    rng = np.random.RandomState(11)
    shapes = [(4, 3), (3,), (5, 2)]
    params16 = [rng.randn(*s).astype(np.float16) for s in shapes]
    kw = dict(dynamic_loss_scale=True, dynamic_loss_args={"init_scale": 2.0 ** 8,
                                                          "scale_window": 2,
                                                          "delayed_shift": 1},
              clip_grad=1.0)
    jopt, topt = jfo.FP16_Optimizer(_INNER[inner][0](), **kw), \
        tfo.FP16_Optimizer(_INNER[inner][1](), **kw)
    jp = [jnp.asarray(p) for p in params16]
    tp = [torch.from_numpy(p.copy()) for p in params16]
    jstate, tstate = jopt.init(jp), topt.init(tp)
    for step in range(5):
        scale = float(tstate.scaler.cur_scale)
        assert scale == float(jstate.scaler.cur_scale)
        grads = [(rng.randn(*s) * scale * 0.1).astype(np.float16) for s in shapes]
        if step == 2:
            grads[1][0] = np.inf
        jp, jstate, jover = jopt.step([jnp.asarray(g) for g in grads], jstate, jp, lr=5e-2)
        tp, tstate, tover = topt.step([torch.from_numpy(g) for g in grads], tstate, tp, lr=5e-2)
        assert tover == bool(jover) == (step == 2)
        assert _state_tuple(tstate.scaler) == _state_tuple(jstate.scaler)
        for t, j, m, jm in zip(tp, jp, tstate.master, jstate.master):
            np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=1e-6, atol=1e-7)
            assert t.dtype == torch.float16
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert topt.skipped_steps == 1
    blob = topt.state_dict(tstate)
    back = topt.load_state_dict(topt.init(tp), blob)
    assert back.inner_state.step == tstate.inner_state.step == 4
    for a, b in zip(back.master, tstate.master):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert _state_tuple(back.scaler) == _state_tuple(tstate.scaler)


# ---------------------------------------------------------------------------
# the layer and the model in fp16
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pre_ln", [True, False])
def test_fp16_layer_forward_and_grads_match_flax(pre_ln):
    kw = dict(hidden_size=32, intermediate_size=64, heads=2, attn_dropout_ratio=0.1,
              hidden_dropout_ratio=0.1, initializer_range=0.02, pre_layer_norm=pre_ln)
    rng = np.random.RandomState(12)
    x = rng.randn(2, SEQ, 32).astype(np.float16)
    r = rng.randn(2, SEQ, 32).astype(np.float16)
    mask = np.where(rng.rand(2, 1, 1, SEQ) < 0.2, -10000.0, 0.0).astype(np.float16)
    jlayer = JLayer(JLayerCfg(**kw))
    p = jlayer.init(jax.random.PRNGKey(3), jnp.asarray(x, jnp.float32),
                    jnp.asarray(mask, jnp.float32), deterministic=True)
    p16 = jax.tree_util.tree_map(lambda a: a.astype(jnp.float16), p)

    def jloss(p, x):
        out = jlayer.apply(p, x, jnp.asarray(mask), deterministic=True)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(r, jnp.float32))

    want_out = jlayer.apply(p16, jnp.asarray(x), jnp.asarray(mask), deterministic=True)
    jg_p, jg_x = jax.grad(jloss, argnums=(0, 1))(p16, jnp.asarray(x))

    layer = DeepSpeedTransformerLayer(DeepSpeedTransformerConfig(**kw))
    pp, gp = _TO_NP(p)["params"], _TO_NP(jg_p)["params"]
    with torch.no_grad():
        for name in ("qkv", "attn_out", "ff1", "ff2"):
            getattr(layer, name).weight.copy_(torch.from_numpy(pp[name]["kernel"].T.copy()))
            getattr(layer, name).bias.copy_(torch.from_numpy(pp[name]["bias"]))
        for name in ("ln_attn", "ln_ffn"):
            getattr(layer, name).weight.copy_(torch.from_numpy(pp[name]["scale"]))
            getattr(layer, name).bias.copy_(torch.from_numpy(pp[name]["bias"]))
    layer.half()
    tx = torch.from_numpy(x).requires_grad_()
    out = layer(tx, torch.from_numpy(mask), deterministic=True)
    assert out.dtype == torch.float16
    (out.float() * torch.from_numpy(r).float()).sum().backward()
    _close(out.detach().float().numpy(), want_out, 1e-3)
    _close(tx.grad.float().numpy(), jg_x, 2e-2)
    for name in ("qkv", "attn_out", "ff1", "ff2"):
        _close(getattr(layer, name).weight.grad.float().numpy().T, gp[name]["kernel"], 2e-2)
        _close(getattr(layer, name).bias.grad.float().numpy(), gp[name]["bias"], 2e-2)
    for name in ("ln_attn", "ln_ffn"):
        _close(getattr(layer, name).weight.grad.float().numpy(), gp[name]["scale"], 2e-2)


def test_fp16_bert_loss_and_grads_match_jax(bert):
    """fp16 weights on both sides (JAX casts the whole tree once, so the
    tied word embedding's two uses sum their fp16 gradients, as the port's
    fp16 module does)."""
    jcfg, jmodel, params, batch = bert
    jb = tuple(jnp.asarray(x) for x in batch)
    p16 = jax.tree_util.tree_map(lambda a: a.astype(jnp.float16), params)
    loss, grads = jax.value_and_grad(
        lambda p: jmodel.apply(p, *jb, deterministic=True))(p16)
    model = BertForPreTraining.from_jax_params(_TO_NP(params), _tcfg(jcfg)).half()
    want = BertForPreTraining.from_jax_params(_TO_NP(grads), _tcfg(jcfg))
    got = model(*(torch.from_numpy(x) for x in batch), deterministic=True)
    got.backward()
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(loss), rtol=1e-3)
    named = dict(want.named_parameters())
    for name, p in model.named_parameters():
        assert p.grad.dtype == torch.float16
        _close(p.grad.float().numpy(), named[name].detach().numpy(), 2e-2)


def test_flash_path_holds_no_sentinel_in_fp16():
    """The -1e30 causal sentinel lives only in fp32 scores and lse: every
    fp16 tensor of the flash path (out, dq, dk, dv) is finite, with a
    whole causal row and fully padded keys."""
    from deepspeed_tpu_torch.ops.transformer import attention as T

    rng = np.random.RandomState(13)
    q, k, v = (torch.from_numpy(rng.randn(1, 2, 32, 16).astype(np.float16)).requires_grad_()
               for _ in range(3))
    mask = torch.zeros(1, 1, 1, 32)
    mask[..., 20:] = -10000.0
    out = T.flash_attention(q, k, v, mask, block=16, causal=True)
    assert out.dtype == torch.float16 and bool(torch.isfinite(out).all())
    out.float().sum().backward()
    for t in (q, k, v):
        assert t.grad.dtype == torch.float16 and bool(torch.isfinite(t.grad).all())


# ---------------------------------------------------------------------------
# engine trajectories against the JAX engine
# ---------------------------------------------------------------------------

def _dataset(n, seed):
    cols = _bert_batch(n, SEQ, 256, seed)
    return [tuple(c[i] for c in cols) for i in range(n)]


# fp16: 2**24 is eight powers of two above fp16's largest value, so the first
# steps overflow on both sides for certain; with hysteresis 1 the scale
# halves each time until the gradients fit, and a window of 3 clean steps
# then grows it again
FP16_CONFIG = {"train_batch_size": 4,
               "fp16": {"enabled": True, "initial_scale_power": 24, "hysteresis": 1,
                        "loss_scale_window": 3},
               "optimizer": {"type": "Lamb", "params": {"lr": 1e-2, "weight_decay": 0.01}},
               "gradient_clipping": 1.0,
               "scheduler": {"type": "WarmupDecayLR",
                             "params": {"warmup_num_steps": 4, "total_num_steps": 30,
                                        "warmup_max_lr": 1e-2}},
               "activation_checkpointing": {"enabled": True}}
BF16_CONFIG = {"train_batch_size": 4, "bf16": {"enabled": True},
               "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
               "gradient_clipping": 1.0, "activation_checkpointing": {"enabled": True}}


def _trajectories(bert, config, steps):
    """Each engine's per-step (loss, loss scale, skipped steps, LR) over
    ``train_batch()`` reading its own loader of ``training_data=``."""
    jcfg, _, params, _ = bert
    data = _dataset(8, seed=3)
    jeng, _, jloader, _ = deepspeed_tpu.initialize(
        model=JBert(_jcfg()), model_parameters=jax.tree_util.tree_map(jnp.array, params),
        config_params=dict(config, mesh={"data_parallel_size": 1}), training_data=data)
    teng, _, tloader, _ = dt.initialize(
        model=BertForPreTraining.from_jax_params(_TO_NP(params), _tcfg(jcfg)),
        config=config, training_data=data, device="cpu")
    assert len(tloader) == len(jloader) == 2
    runs = []
    for eng in (jeng, teng):
        rows = []
        for _ in range(steps):
            lr = eng.get_lr()[0]
            rows.append((eng.train_batch(), eng.loss_scale(), eng.skipped_steps, lr))
        runs.append(rows)
    return runs


def test_fp16_engine_trajectory_matches_jax(bert):
    want, got = _trajectories(bert, FP16_CONFIG, 16)
    losses = lambda rows: [r[0] for r in rows]
    np.testing.assert_allclose(losses(got), losses(want), rtol=1e-4)
    assert [r[1:] for r in got] == [r[1:] for r in want]
    skipped = [r[2] for r in got]
    assert skipped[0] == 1 and 1 < skipped[-1] < 16       # overflows, then clean steps
    scales = [r[1] for r in got]
    assert min(scales) < 2.0 ** 16 and scales[-1] > min(scales)   # backed off, then grew
    assert got[-1][0] < got[0][0]


def test_bf16_engine_trajectory_matches_jax(bert):
    """The bf16 Adam path step for step against the JAX engine (the
    question of BERT-large's loss jump at step 2 on the card is whether
    the port's engine departs from the JAX engine's; at this width it
    does not)."""
    want, got = _trajectories(bert, BF16_CONFIG, 8)
    np.testing.assert_allclose([r[0] for r in got], [r[0] for r in want], rtol=2e-3)
    assert [r[1:] for r in got] == [r[1:] for r in want] == [(1.0, 0, 1e-3)] * 8
    assert got[-1][0] < got[0][0]
