"""The port's training path, held against the JAX package on the CPU.

``deepspeed_tpu_torch.initialize`` -> ``train_step`` over
``BertForPreTraining``, its layer, loss, optimizer and config, each fed
the same numpy inputs and (through ``from_jax_params``) the same weights
as the JAX package. The attention inside runs the flash kernels' plain
PyTorch versions (sequence 128, the kernel block); the CUDA kernels are
held against those on the card by ``chip_smoke.py``.

Tolerances, all fp32: 1e-5 for a layer, the loss and the optimizer (the
same math summed in another order); 2e-5 relative to each gradient's
largest magnitude for the whole model (two dozen ops deep). The 6-step
engine trajectory is compared at 1e-4 relative: Adam's first step moves
every weight by +-lr * sign(g), so a gradient element within rounding of
zero may step the other way on the two sides, and later losses inherit
that difference.
"""

import dataclasses
import json

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
from deepspeed_tpu.ops.cross_entropy import chunked_cross_entropy as jcce  # noqa: E402
from deepspeed_tpu.ops.transformer.transformer import (  # noqa: E402
    DeepSpeedTransformerConfig as JLayerCfg,
    DeepSpeedTransformerLayer as JLayer,
)
from deepspeed_tpu.runtime import config as jconfig  # noqa: E402
from deepspeed_tpu_torch.models.bert import (  # noqa: E402
    BertConfig,
    BertForPreTraining,
    BertForQuestionAnswering,
)
from deepspeed_tpu_torch.ops.adam.fused_adam import FusedAdam  # noqa: E402
from deepspeed_tpu_torch.ops.cross_entropy import chunked_cross_entropy  # noqa: E402
from deepspeed_tpu_torch.ops.transformer.transformer import (  # noqa: E402
    DeepSpeedTransformerConfig,
    DeepSpeedTransformerLayer,
)
from deepspeed_tpu_torch.runtime import config as tconfig  # noqa: E402
from deepspeed_tpu_torch.runtime import lr_schedules as tsched  # noqa: E402

SEQ = 128   # the kernels' block: the attention runs kernels 1-3's plain versions
_TO_NP = lambda tree: jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    yield


def _close(got, want, tol):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = max(1e-3, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _jcfg(**kw):
    return dataclasses.replace(_tiny_bert_config(), max_position_embeddings=SEQ, **kw)


def _tcfg(jcfg):
    d = dataclasses.asdict(jcfg)
    d.pop("scan_unroll")
    return BertConfig(**d)


def _batch(B, seed=0, vocab=256):
    return _bert_batch(B, SEQ, vocab, seed)


def _tbatch(batch):
    return tuple(torch.from_numpy(x) for x in batch)


@pytest.fixture(scope="module")
def bert():
    jcfg = _jcfg()
    jmodel = JBert(jcfg)
    batch = _batch(2)
    params = jmodel.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                         *(jnp.asarray(x) for x in batch))
    return jcfg, jmodel, params, batch


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pre_ln", [True, False])
def test_layer_forward_and_grads_match_flax(pre_ln):
    kw = dict(hidden_size=32, intermediate_size=64, heads=2, attn_dropout_ratio=0.1,
              hidden_dropout_ratio=0.1, initializer_range=0.02, pre_layer_norm=pre_ln)
    rng = np.random.RandomState(1)
    x = rng.randn(2, SEQ, 32).astype(np.float32)
    r = rng.randn(2, SEQ, 32).astype(np.float32)
    mask = np.where(rng.rand(2, 1, 1, SEQ) < 0.2, -10000.0, 0.0).astype(np.float32)
    jlayer = JLayer(JLayerCfg(**kw))
    p = jlayer.init(jax.random.PRNGKey(3), jnp.asarray(x), jnp.asarray(mask),
                    deterministic=True)

    def jloss(p, x):
        return jnp.sum(jlayer.apply(p, x, jnp.asarray(mask), deterministic=True) * r)

    want_out = jlayer.apply(p, jnp.asarray(x), jnp.asarray(mask), deterministic=True)
    jg_p, jg_x = jax.grad(jloss, argnums=(0, 1))(p, jnp.asarray(x))

    layer = DeepSpeedTransformerLayer(DeepSpeedTransformerConfig(**kw))
    pp, gp = _TO_NP(p)["params"], _TO_NP(jg_p)["params"]
    with torch.no_grad():
        for name in ("qkv", "attn_out", "ff1", "ff2"):
            getattr(layer, name).weight.copy_(torch.from_numpy(pp[name]["kernel"].T.copy()))
            getattr(layer, name).bias.copy_(torch.from_numpy(pp[name]["bias"]))
        for name in ("ln_attn", "ln_ffn"):
            getattr(layer, name).weight.copy_(torch.from_numpy(pp[name]["scale"]))
            getattr(layer, name).bias.copy_(torch.from_numpy(pp[name]["bias"]))
    tx = torch.from_numpy(x).requires_grad_()
    out = layer(tx, torch.from_numpy(mask), deterministic=True)
    (out * torch.from_numpy(r)).sum().backward()
    _close(out.detach().numpy(), want_out, 1e-5)
    _close(tx.grad.numpy(), jg_x, 1e-5)
    for name in ("qkv", "attn_out", "ff1", "ff2"):
        _close(getattr(layer, name).weight.grad.numpy().T, gp[name]["kernel"], 1e-5)
        _close(getattr(layer, name).bias.grad.numpy(), gp[name]["bias"], 1e-5)
    for name in ("ln_attn", "ln_ffn"):
        _close(getattr(layer, name).weight.grad.numpy(), gp[name]["scale"], 1e-5)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_bert_pretraining_loss_and_grads_match_jax(bert):
    jcfg, jmodel, params, batch = bert
    jb = tuple(jnp.asarray(x) for x in batch)
    loss, grads = jax.value_and_grad(
        lambda p: jmodel.apply(p, *jb, deterministic=True))(params)
    model = BertForPreTraining.from_jax_params(_TO_NP(params), _tcfg(jcfg))
    want = BertForPreTraining.from_jax_params(_TO_NP(grads), _tcfg(jcfg))
    got = model(*_tbatch(batch), deterministic=True)
    got.backward()
    np.testing.assert_allclose(float(got), float(loss), rtol=1e-5)
    named = dict(want.named_parameters())
    for name, p in model.named_parameters():
        _close(p.grad.numpy(), named[name].detach().numpy(), 2e-5)


def test_from_jax_params_layout(bert):
    jcfg, _, params, _ = bert
    model = BertForPreTraining.from_jax_params(_TO_NP(params), _tcfg(jcfg))
    (stack,) = params["params"]["bert"]["encoder"]["layers"].values()
    np.testing.assert_array_equal(model.bert.encoder.layers[1].ff1.weight.detach().numpy(),
                                  np.asarray(stack["ff1"]["kernel"][1]).T)
    assert model.bert.embeddings.LayerNorm.eps == 1e-6
    assert len(model.bert.encoder.layers) == jcfg.num_hidden_layers


def test_chunked_cross_entropy_matches_jax():
    rng = np.random.RandomState(4)
    h = rng.randn(3, 13, 8).astype(np.float32)
    w = rng.randn(8, 50).astype(np.float32)
    b = rng.randn(50).astype(np.float32)
    y = np.where(rng.rand(3, 13) < 0.5, rng.randint(0, 50, (3, 13)), -1).astype(np.int32)
    jf = lambda h, w, b: jcce(h, w, b, jnp.asarray(y), rows_per_chunk=8)
    want, jgrads = jax.value_and_grad(jf, argnums=(0, 1, 2))(*map(jnp.asarray, (h, w, b)))
    ts = [torch.from_numpy(x).requires_grad_() for x in (h, w, b)]
    got = chunked_cross_entropy(*ts, torch.from_numpy(y), rows_per_chunk=8)
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    for t, g in zip(ts, jgrads):
        _close(t.grad.numpy(), g, 1e-5)


@pytest.mark.parametrize("adam_w_mode,bias_correction", [(True, True), (False, True),
                                                           (True, False)])
def test_fused_adam_matches_jax(adam_w_mode, bias_correction):
    rng = np.random.RandomState(5)
    shapes = {"w": (4, 3), "ln_bias": (3,), "v": (5,)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    kw = dict(lr=1e-2, weight_decay=0.1, adam_w_mode=adam_w_mode,
              bias_correction=bias_correction, no_decay_names=["bias"])
    jopt, topt = JAdam(**kw), FusedAdam(**kw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jopt.init(jp)
    names = list(shapes)
    tp = [torch.from_numpy(params[k].copy()) for k in names]
    tstate = topt.init(tp)
    for _ in range(5):
        grads = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
        jp, jstate = jopt.update({k: jnp.asarray(v) for k, v in grads.items()}, jstate, jp)
        topt.update([torch.from_numpy(grads[k]) for k in names], tstate, tp, names=names)
        for k, t in zip(names, tp):
            np.testing.assert_allclose(t.numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)
    assert tstate.step == int(jstate.step) == 5


def test_norm_clip_and_overflow_match_jax():
    from deepspeed_tpu.runtime import utils as jutils
    from deepspeed_tpu_torch.runtime import utils as tutils

    rng = np.random.RandomState(6)
    grads = [rng.randn(*s).astype(np.float32) for s in ((3, 4), (5,), (2, 2, 2))]
    jg = [jnp.asarray(g) for g in grads]
    tg = [torch.from_numpy(g.copy()) for g in grads]
    np.testing.assert_allclose(float(tutils.global_norm(tg)), float(jutils.global_norm(jg)),
                               rtol=1e-6)
    jclipped, jnorm = jutils.clip_grad_norm_(jg, 0.5)
    tnorm = tutils.clip_grad_norm_(tg, 0.5)
    np.testing.assert_allclose(float(tnorm), float(jnorm), rtol=1e-6)
    for t, j in zip(tg, jclipped):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-7)
    assert not bool(tutils.has_overflow(tg))
    tg[1][2] = float("nan")
    assert bool(tutils.has_overflow(tg)) == bool(jutils.has_overflow(
        [jnp.asarray(t.numpy()) for t in tg]))
    before = [t.clone() for t in tg]
    assert not torch.isfinite(tutils.clip_grad_norm_(tg, 0.5))
    for t, b in zip(tg, before):   # a non-finite norm leaves the grads unclipped
        torch.testing.assert_close(t, b, equal_nan=True)


def test_fold_seed_is_deterministic_and_spreads():
    from deepspeed_tpu_torch.runtime.utils import fold_seed

    assert fold_seed(42, 3) == fold_seed(42, 3)
    seeds = {fold_seed(42, i) for i in range(100)} | {fold_seed(43, i) for i in range(100)}
    assert len(seeds) == 200 and all(0 <= s < 2**63 for s in seeds)
    assert fold_seed(fold_seed(1, 2), 3) != fold_seed(fold_seed(1, 3), 2)


# ---------------------------------------------------------------------------
# the config
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg,world", [
    ({"train_batch_size": 16, "train_micro_batch_size_per_gpu": 4}, 2),
    ({"train_batch_size": 16, "gradient_accumulation_steps": 2}, 2),
    ({"train_micro_batch_size_per_gpu": 4, "gradient_accumulation_steps": 3}, 1),
    ({"train_batch_size": 8}, 2),
    ({"train_micro_batch_size_per_gpu": 3}, 1),
    ({"train_batch_size": 12, "train_micro_batch_size_per_gpu": 2,
      "gradient_accumulation_steps": 3}, 2),
])
def test_config_batch_triple_matches_jax(cfg, world):
    want = jconfig.DeepSpeedConfig(dict(cfg), world_size=world)
    got = tconfig.DeepSpeedConfig(dict(cfg), world_size=world)
    for key in ("train_batch_size", "train_micro_batch_size_per_gpu",
                "gradient_accumulation_steps"):
        assert getattr(got, key) == getattr(want, key)


def test_config_errors_match_jax(tmp_path):
    bad = [({"train_batch_size": 10, "train_micro_batch_size_per_gpu": 4,
             "gradient_accumulation_steps": 2}, AssertionError, AssertionError),
           ({"gradient_accumulation_steps": 2}, jconfig.DeepSpeedConfigError,
            tconfig.DeepSpeedConfigError),
           ({"train_batch_size": 4, "fp16": {"enabled": True}, "bf16": {"enabled": True}},
            jconfig.DeepSpeedConfigError, tconfig.DeepSpeedConfigError)]
    for cfg, jerr, terr in bad:
        with pytest.raises(jerr):
            jconfig.DeepSpeedConfig(dict(cfg), world_size=1)
        with pytest.raises(terr):
            tconfig.DeepSpeedConfig(dict(cfg), world_size=1)
    path = tmp_path / "dup.json"
    path.write_text('{"train_batch_size": 4, "train_batch_size": 8}')
    for cls in (jconfig.DeepSpeedConfig, tconfig.DeepSpeedConfig):
        with pytest.raises(ValueError, match="Duplicate"):
            cls(str(path), world_size=1)
    path.write_text(json.dumps({"train_batch_size": 4, "seed": 7}))
    assert tconfig.DeepSpeedConfig(str(path)).seed == 7


@pytest.mark.parametrize("section", [
    {"elasticity": {"enabled": True}},
    {"curriculum_learning": {"enabled": True}},
    {"optimizer": {"type": "OneBitAdam"}}, {"progressive_layer_drop": {"enabled": True}},
    {"pipeline": {"stages": 2}}, {"sparse_attention": {"mode": "fixed"}},
    {"telemetry": {"enabled": True}}, {"resilience": {}},
    {"flops_profiler": {"enabled": True}},
    {"activation_checkpointing": {"enabled": True, "cpu_checkpointing": True}},
    {"activation_checkpointing": {"enabled": True, "partition_activations": True}},
    {"amp": {"enabled": True}}, {"wall_clock_breakdown": True},
    {"tensorboard": {"enabled": True}}, {"sparse_gradients": True},
])
def test_config_refuses_sections_not_ported(section):
    with pytest.raises(NotImplementedError, match="not ported"):
        tconfig.DeepSpeedConfig({"train_batch_size": 4, **section}, world_size=1)


class _Quadratic(torch.nn.Module):
    def __init__(self):
        super().__init__()
        torch.manual_seed(0)
        self.lin = torch.nn.Linear(3, 1)

    def forward(self, x):
        return (self.lin(x) ** 2).mean()


@pytest.mark.parametrize("section", [
    {"fp16": {"enabled": True}},
    {"fp16": {"enabled": True, "loss_scale": 128}},
    {"fp16": {"enabled": True, "initial_scale_power": 16, "loss_scale_window": 500,
              "hysteresis": 1, "min_loss_scale": 4}},
    {"scheduler": {"type": "WarmupLR", "params": {"warmup_max_lr": 0.01}}},
    {"scheduler": {"type": "OneCycle", "params": {"cycle_max_lr": 0.01}}},
    {"optimizer": {"type": "Lamb", "params": {"lr": 2e-3, "max_coeff": 0.3}}},
    {"optimizer": {"type": "SGD", "params": {"lr": 0.1, "momentum": 0.9}}},
])
def test_config_builds_an_engine_for_sections_now_ported(section):
    """fp16, schedulers, Lamb and SGD build an engine, and the parsed
    values equal the JAX ``DeepSpeedConfig``'s."""
    cfg = {"train_batch_size": 4, "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
           **section}
    want = jconfig.DeepSpeedConfig(dict(cfg), world_size=1)
    got = tconfig.DeepSpeedConfig(dict(cfg), world_size=1)
    for key in ("fp16_enabled", "loss_scale", "initial_dynamic_scale",
                "dynamic_loss_scale_args", "scheduler_name", "scheduler_params",
                "optimizer_name", "optimizer_params"):
        assert getattr(got, key) == getattr(want, key), key

    engine, opt, loader, sched = dt.initialize(model=_Quadratic(), config=cfg, device="cpu")
    assert engine.fp16_enabled() == want.fp16_enabled
    assert engine.compute_dtype == (torch.float16 if want.fp16_enabled else torch.float32)
    assert type(opt).__name__ == {"adam": "FusedAdam", "lamb": "FusedLamb",
                                  "sgd": "SGD"}[want.optimizer_name]
    assert (sched is None) == (want.scheduler_name is None)
    assert loader is None
    if want.fp16_enabled:
        dynamic = want.loss_scale == 0
        assert engine.dynamic_loss_scale() == dynamic
        args = want.dynamic_loss_scale_args or {}
        assert engine.loss_scale() == (args.get("init_scale", want.initial_dynamic_scale)
                                       if dynamic else want.loss_scale)



def test_engine_lr_scheduler_argument_and_conflict():
    """A schedule passed as ``lr_scheduler=`` is primed once and feeds
    the optimizer: SGD's step is exactly lr times the gradient."""
    cfg = {"train_batch_size": 2, "optimizer": {"type": "SGD", "params": {"lr": 0.5}}}
    sched = tsched.WarmupLR(warmup_min_lr=0.0, warmup_max_lr=0.2, warmup_num_steps=3)
    engine, _, _, got = dt.initialize(model=_Quadratic(), config=cfg, lr_scheduler=sched,
                                      device="cpu")
    assert got is sched and sched.last_batch_iteration == 0   # primed once
    x = torch.ones(2, 3)
    lrs = []
    for _ in range(4):
        lrs.append(engine.get_lr()[0])
        before = engine.module.lin.bias.detach().clone()
        loss = engine.forward(x)
        engine.backward(loss)
        grad = engine._acc_grads[1].clone()
        engine.step()
        torch.testing.assert_close(engine.module.lin.bias.detach(), before - lrs[-1] * grad)
    want = tsched.WarmupLR(warmup_min_lr=0.0, warmup_max_lr=0.2, warmup_num_steps=3)
    assert lrs == [want.step()[0] for _ in range(4)]
    assert engine.get_mom() == [0.9]                # SGD has no betas: the default
    with pytest.raises(ValueError, match="both scheduler"):
        dt.initialize(model=_Quadratic(), device="cpu",
                      config=dict(cfg, scheduler={"type": "WarmupLR", "params": {}}),
                      lr_scheduler=tsched.WarmupLR())


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _ds_config(**kw):
    cfg = {"train_batch_size": 4, "gradient_accumulation_steps": 1,
           "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
           "gradient_clipping": 1.0, "activation_checkpointing": {"enabled": True}}
    cfg.update(kw)
    return cfg


def _engine(model, **kw):
    engine, _, _, _ = dt.initialize(model=model, config=_ds_config(**kw), device="cpu")
    return engine


def test_engine_trajectory_matches_jax(bert):
    """Six fused train steps from identical weights, fp32, dropout off."""
    jcfg, jmodel, params, _ = bert
    batch = _batch(4, seed=1)
    jeng, _, _, _ = deepspeed_tpu.initialize(
        model=JBert(_jcfg()), model_parameters=jax.tree_util.tree_map(jnp.array, params),
        config_params=_ds_config(mesh={"data_parallel_size": 1}))
    jb = tuple(jnp.asarray(x) for x in batch)
    want = [float(jeng.train_step([jb])) for _ in range(6)]
    teng = _engine(BertForPreTraining.from_jax_params(_TO_NP(params), _tcfg(jcfg)))
    got = [float(teng.train_step([_tbatch(batch)])) for _ in range(6)]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]
    assert teng.global_steps == 6 and teng.global_samples == 24


def _dropout_model(**kw):
    cfg = _tcfg(_jcfg(hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1, **kw))
    torch.manual_seed(0)
    return dt.init_bert(cfg, seed=0, device="cpu")


def test_three_call_api_equals_fused_train_step():
    batch = _tbatch(_batch(4, seed=2))
    fused, three = _engine(_dropout_model()), _engine(_dropout_model())
    for _ in range(2):
        want = fused.train_step([batch])
        got = three.forward(*batch)
        three.backward(got)
        three.step()
        assert float(got) == float(want)
    for (name, a), b in zip(fused.master_params().items(), three.master_params().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)
    assert three.global_steps == fused.global_steps == 2


def test_eval_forward_is_deterministic_and_grad_free():
    batch = _tbatch(_batch(2, seed=5))
    engine = _engine(_dropout_model())
    engine.eval()
    first, second = engine.forward(*batch), engine.forward(*batch)
    assert not first.requires_grad
    assert float(first) == float(second)
    with torch.no_grad():
        want = engine.module(*batch, deterministic=True)
    np.testing.assert_allclose(float(first), float(want), rtol=1e-6)
    engine.train()
    assert engine.forward(*batch).requires_grad


class _Regression(torch.nn.Module):
    """A model without a per-layer ``checkpoint_activations`` switch."""

    def __init__(self):
        super().__init__()
        torch.manual_seed(0)
        self.fc1, self.fc2 = torch.nn.Linear(8, 16), torch.nn.Linear(16, 1)

    def forward(self, x, y):
        return torch.mean((self.fc2(torch.tanh(self.fc1(x))) - y) ** 2)


def test_engine_recomputes_a_model_without_a_remat_switch():
    rng = np.random.RandomState(7)
    batch = (rng.randn(4, 8).astype(np.float32), rng.randn(4, 1).astype(np.float32))
    runs = []
    for enabled in (False, True):
        engine = _engine(_Regression(), activation_checkpointing={"enabled": enabled})
        assert engine._remat_module == enabled
        runs.append([float(engine.train_step([batch])) for _ in range(3)])
        runs.append(engine.master_params())
    np.testing.assert_allclose(runs[2], runs[0], rtol=1e-6)
    for name, p in runs[1].items():
        torch.testing.assert_close(runs[3][name], p, rtol=1e-6, atol=1e-7, msg=name)


def _record_grads(engine):
    """Keep a copy of the accumulated gradients of each of ``engine``'s
    steps (Adam's normalized step would hide a wrong gradient scale)."""
    seen, update = [], engine._update

    def recording():
        seen.append([g.clone() for g in engine._acc_grads])
        return update()

    engine._update = recording
    return seen


def test_gradient_accumulation_equals_one_double_batch(bert):
    """gas 2 over two halves == gas 1 over the whole batch, when every row
    carries the same number of MLM labels (the loss is a mean over
    labels, so halves with different counts would weigh rows
    differently)."""
    ids, types, att, _, nsp = _batch(4, seed=3)
    labels = np.full(ids.shape, -1, np.int32)
    labels[:, 3:9] = ids[:, 3:9]
    whole = (ids, types, att, labels, nsp)
    halves = [tuple(x[i:i + 2] for x in whole) for i in (0, 2)]
    jcfg, _, params, _ = bert
    model = lambda: BertForPreTraining.from_jax_params(_TO_NP(params), _tcfg(jcfg))
    base = _engine(model())
    acc = _engine(model(), train_micro_batch_size_per_gpu=2, gradient_accumulation_steps=2)
    seen_base, seen_acc = _record_grads(base), _record_grads(acc)
    for _ in range(2):
        want = base.train_step([_tbatch(whole)])
        got = acc.train_step([_tbatch(h) for h in halves])
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert len(seen_acc) == len(seen_base) == 2
    for step_a, step_b in zip(seen_acc, seen_base):
        for a, b in zip(step_a, step_b):
            _close(a.numpy(), b.numpy(), 1e-5)


@pytest.mark.parametrize("policy", ["nothing", "dots"])
def test_remat_grads_equal_plain_grads_with_dropout(policy):
    """Recomputing a layer must redraw its dropout masks exactly: grads
    with activation checkpointing on equal grads with it off, at the
    same dropout seed, with attention and hidden dropout 0.1."""
    batch = _tbatch(_batch(2, seed=4))
    grads = []
    for remat in (False, True):
        model = _dropout_model(checkpoint_activations=remat, checkpoint_policy=policy)
        model(*batch, dropout_seed=1234).backward()
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
    for name, g in grads[0].items():
        torch.testing.assert_close(grads[1][name], g, rtol=0, atol=1e-6, msg=name)
    model = _dropout_model()
    other = model(*batch, dropout_seed=1235)
    assert float(other) != float(_dropout_model()(*batch, dropout_seed=1234))


def test_entry_points_run_on_the_card_unless_asked(monkeypatch):
    """Without ``device="cpu"`` the entry points ask for CUDA and raise on
    a box without a card; nothing carries on silently on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _tcfg(_jcfg())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dt.init_bert(cfg)
    model = dt.init_bert(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dt.initialize(model=model, config=_ds_config())
    with pytest.raises(NotImplementedError, match="progressive layer drop"):
        model(*_tbatch(_batch(2)), progressive_layer_drop=True)
    with pytest.raises(NotImplementedError, match="BertForQuestionAnswering"):
        BertForQuestionAnswering(cfg)
