"""The port's ``PipelineEngine`` on the CPU: the MLP pipeline of
``tests/unit/test_pipe.py`` against the JAX ``PipelineEngine``
(interpreted, ``mesh.data_parallel_size`` 1, so a JAX step and a port
step see the same global batch) from the same weights, then the port's
own contracts.

Against JAX, at 1, 2 and 4 stages, Adam lr 1e-2, fp32, 4 steps:
losses within rtol 1e-5 (measured 1.6e-7) and masters within atol 1e-5
(measured 6.0e-8: the same sums in another order; Adam moves an element
by about lr whatever its gradient's size). The tied run (a Dense layer
shared by layers 0 and 4; 2.3e-7 and 1.2e-7) keeps its two copies equal
bit for bit. The fp16 run (dynamic scaling from 2^20, window 2, and a
WarmupLR schedule) must skip the same steps (1 and 2 of 4) at the same
scales, the schedule held on them; losses within rtol 1e-3 (measured
3.7e-6) and masters within atol 1e-3, a tenth of lr (measured 1.5e-4):
the port runs the MLP in fp16 (floating inputs enter in the compute
dtype), JAX promotes its fp16 weights against the fp32 inputs. A run
clipped at 0.05 (2.4e-7, 6.0e-8) and ``eval_batch`` on fresh data
(7.2e-8; fp16 2.9e-6) are held as the runs they follow; every run's LR
equals the JAX engine's after every step.

Port-only: a tag saved at 4 stages and loaded at 2 continues bit for bit
(GPT-2 tiny with dropout 0.1: the masks follow the layer, not the
stage), the optimizer state round-trips; the recomputing backward's
gradients equal autograd through one stored graph of the whole model on
the same seeds, bit for bit; a NaN loss injected at step 2 rolls back and
ends equal to the clean run; ``zero_to_fp32`` on a pipeline tag equals
``_gather_layer_params()``; the refusals by name; world 2 over gloo
(each process the whole pipeline, half the batch) equals world 1 on the
whole batch (losses rtol 1e-5, masters atol 1e-5; measured 7.9e-8 and
1.3e-7). The world-2 run waits at most ``TIMEOUT_S``.
"""

import os
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from torch import nn

import deepspeed_tpu_torch as dt
from deepspeed_tpu_torch.models.gpt2_pipe import build_gpt2_pipeline
from deepspeed_tpu_torch.runtime.pipe.engine import PipelineEngine
from deepspeed_tpu_torch.runtime.pipe.module import (
    LayerSpec,
    PipelineError,
    PipelineModule,
    TiedLayerSpec,
)
from deepspeed_tpu_torch.utils.zero_to_fp32 import get_fp32_state_dict_from_zero_checkpoint

HIDDEN = 16
GLOBAL_MB = 32
STEPS = 4
TIMEOUT_S = 120


# ---------------------------------------------------------------------------
# the MLP pipeline of tests/unit/test_pipe.py, in both packages
# ---------------------------------------------------------------------------

class DenseLayer(nn.Module):
    param_count = HIDDEN * HIDDEN

    def __init__(self):
        super().__init__()
        self.dense = nn.Linear(HIDDEN, HIDDEN)

    def forward(self, x):
        return self.dense(x)

    @staticmethod
    def jax_state_dict(tree):
        p = tree["params"]["Dense_0"]
        return {"dense.weight": torch.as_tensor(np.asarray(p["kernel"]).T.copy()),
                "dense.bias": torch.as_tensor(np.array(p["bias"]))}


class ReluLayer(nn.Module):
    param_count = 0

    def forward(self, x):
        return torch.relu(x)


def mse_loss(out, label):
    return torch.mean((out.float() - label.float()) ** 2)


def _jax_layers(tied):
    """The flax layers of ``tests/unit/test_pipe.py:22-83``."""
    import flax.linen as flax_nn
    from deepspeed_tpu.runtime.pipe.module import LayerSpec as JaxLayerSpec
    from deepspeed_tpu.runtime.pipe.module import TiedLayerSpec as JaxTiedLayerSpec

    class JaxDense(flax_nn.Module):
        features: int = HIDDEN
        param_count: int = HIDDEN * HIDDEN

        @flax_nn.compact
        def __call__(self, x):
            return flax_nn.Dense(self.features)(x)

    class JaxRelu(flax_nn.Module):
        param_count: int = 0

        @flax_nn.compact
        def __call__(self, x):
            return flax_nn.relu(x)

    D, R = (lambda: JaxLayerSpec(JaxDense)), (lambda: JaxLayerSpec(JaxRelu))
    if tied:
        return [JaxTiedLayerSpec("emb", JaxDense), R(), D(), R(),
                JaxTiedLayerSpec("emb", JaxDense), R()]
    return [D(), R()] * 4


def _jax_mse(out, label):
    import jax.numpy as jnp

    return jnp.mean((out.astype(jnp.float32) - label.astype(jnp.float32)) ** 2)


def _torch_layers(tied):
    if tied:
        return [TiedLayerSpec("emb", DenseLayer), LayerSpec(ReluLayer), LayerSpec(DenseLayer),
                LayerSpec(ReluLayer), TiedLayerSpec("emb", DenseLayer), LayerSpec(ReluLayer)]
    return [LayerSpec(c) for c in (DenseLayer, ReluLayer) * 4]


def _data(n, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        x = rng.randn(GLOBAL_MB, HIDDEN).astype(np.float32)
        y = np.tanh(x.sum(axis=1, keepdims=True)) * np.ones((1, HIDDEN), np.float32)
        out.append((x, y))
    return out


def _config(extra=None, mb=GLOBAL_MB, gas=2, world=1):
    cfg = {"train_batch_size": mb * gas * world, "train_micro_batch_size_per_gpu": mb,
           "gradient_accumulation_steps": gas, "steps_per_print": 1000,
           "optimizer": {"type": "Adam", "params": {"lr": 1e-2}}}
    cfg.update(extra or {})
    return cfg


# the JAX runs: (name -> (stages, tied, config extra)); each runs once a module
RUNS = {
    "plain1": (1, False, {}),
    "plain2": (2, False, {}),
    "plain4": (4, False, {}),
    "tied": (2, True, {}),
    "fp16": (2, False, {"fp16": {"enabled": True, "loss_scale": 0, "initial_scale_power": 20,
                                 "loss_scale_window": 2},
                        "scheduler": {"type": "WarmupLR", "params": {
                            "warmup_min_lr": 1e-3, "warmup_max_lr": 1e-2,
                            "warmup_num_steps": 4}}}),
    "clip": (2, False, {"gradient_clipping": 0.05}),
}


def _run_jax(name):
    import jax
    import jax.numpy as jnp

    import deepspeed_tpu
    from deepspeed_tpu.runtime.pipe.module import PipelineModule as JaxPipelineModule

    stages, tied, extra = RUNS[name]
    jm = JaxPipelineModule(_jax_layers(tied), num_stages=stages, loss_fn=_jax_mse,
                           partition_method="uniform")
    init = jm.init_params(jnp.zeros((GLOBAL_MB, HIDDEN), jnp.float32))
    init = [None if p is None else jax.tree_util.tree_map(np.asarray, p) for p in init]
    cfg = _config(dict(extra, mesh={"data_parallel_size": 1},
                       pipeline={"executor": "interpreted"}))
    engine, _, _, _ = deepspeed_tpu.initialize(model=jm, config_params=cfg)
    it = iter(_data(STEPS * 2))
    losses, skipped, scales, lrs = [], [], [], []
    for _ in range(STEPS):
        losses.append(engine.train_batch(it))
        skipped.append(engine.skipped_steps)
        scales.append(float(engine.scaler_state.cur_scale))
        lrs.append(engine.get_lr()[0])
    ev = engine.eval_batch(iter(_data(2, seed=7)))
    final = [None if p is None else jax.tree_util.tree_map(np.asarray, p)
             for p in engine._gather_layer_params()]
    return dict(init=init, losses=losses, skipped=skipped, scales=scales, lrs=lrs, eval=ev,
                final=final)


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX oracle (the spawned world-2 workers import this module
    without JAX)."""
    pytest.importorskip("jax")
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _run_jax(name)
        return cache[name]
    return get


def _torch_engine(stages, tied=False, extra=None, init=None, **kw):
    module = PipelineModule(_torch_layers(tied), num_stages=stages, loss_fn=mse_loss,
                            partition_method="uniform")
    if init is not None:
        module.load_jax_params(init)
    engine, _, _, _ = dt.initialize(model=module, config_params=_config(extra, **kw),
                                    device="cpu")
    return engine


def _torch_batches(data):
    return [(torch.as_tensor(x), torch.as_tensor(y)) for x, y in data]


def _assert_masters(engine, want_layers, atol):
    for idx, got in enumerate(engine._gather_layer_params()):
        if not got:
            continue
        want = engine.module.get_layers()[idx].jax_state_dict(want_layers[idx])
        for k, v in got.items():
            torch.testing.assert_close(v, want[k], rtol=0, atol=atol, msg=f"layer {idx} {k}")


@pytest.mark.parametrize("name", ["plain1", "plain2", "plain4", "tied", "fp16", "clip"])
def test_mlp_pipeline_matches_jax(name, jax_runs):
    want = jax_runs(name)
    stages, tied, extra = RUNS[name]
    engine = _torch_engine(stages, tied, extra, init=want["init"])
    assert isinstance(engine, PipelineEngine)
    it = iter(_torch_batches(_data(STEPS * 2)))
    losses, skipped, scales, lrs = [], [], [], []
    for _ in range(STEPS):
        losses.append(engine.train_batch(it))
        skipped.append(engine.skipped_steps)
        scales.append(engine.loss_scale() if engine._fp16 else 1.0)
        lrs.append(engine.get_lr()[0])
    fp16 = name == "fp16"
    np.testing.assert_allclose(losses, want["losses"], rtol=1e-3 if fp16 else 1e-5)
    _assert_masters(engine, want["final"], atol=1e-3 if fp16 else 1e-5)
    ev = engine.eval_batch(iter(_torch_batches(_data(2, seed=7))))
    np.testing.assert_allclose(ev, want["eval"], rtol=1e-3 if fp16 else 1e-5)
    np.testing.assert_allclose(lrs, want["lrs"], rtol=1e-12)
    if fp16:
        assert skipped == want["skipped"] and scales == want["scales"]
        assert 0 < skipped[-1] < STEPS, skipped        # both kinds of step ran
        assert lrs[0] == lrs[1] < lrs[2] < lrs[3]        # held on the skipped steps
    if tied:
        owner, user = (engine._slot(engine._masters, i) for i in (0, 4))
        assert all(torch.equal(a, b) for a, b in zip(owner, user))
        assert engine._tied == {"emb": [(0, 0), (1, 4)]}


def test_only_train_batch_and_eval():
    engine = _torch_engine(2)
    for method in (engine.forward, engine.backward, engine.step):
        with pytest.raises(PipelineError):
            method()
    with pytest.raises(PipelineError, match="pairs"):
        engine.train_batch(iter([torch.zeros(2)]))


# ---------------------------------------------------------------------------
# refusals by name
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("extra,kw,match", [
    ({"pipeline": {"executor": "compiled"}}, {}, "executor 'compiled'"),
    ({"zero_optimization": {"stage": 1, "cpu_offload": True}}, {},
     "cpu_offload under a pipeline"),
])
def test_pipeline_refusals_by_name(extra, kw, match):
    module = PipelineModule(_torch_layers(False), num_stages=2, loss_fn=mse_loss)
    with pytest.raises(NotImplementedError, match=match):
        dt.initialize(model=module, config_params=_config(extra), device="cpu", **kw)


@pytest.mark.parametrize("extra,with_mpu", [
    ({"zero_optimization": {"stage": 1}}, False),
    ({"zero_optimization": {"stage": 2}}, False),
    ({"zero_optimization": {"stage": 3}}, False),
    ({"tensor_parallel": {"size": 1}, "mesh": {"data_parallel_size": 1}}, False),
    ({"parallel": {"mesh_shape": [1, 1]}}, False),
    ({}, True),
])
def test_pipeline_accepts_zero_tensor_parallel_mesh_and_mpu(extra, with_mpu):
    """ZeRO 1-3, the mesh sections, a parallel block and ``mpu=`` build a
    pipeline; at world 1 its losses are the plain pipeline's."""
    from deepspeed_tpu_torch.parallel.mesh import MeshMpu, create_mesh

    kw = {"mpu": MeshMpu(create_mesh())} if with_mpu else {}
    data = _data(6)
    plain = _torch_engine(2)
    want = [plain.train_batch(iter(_torch_batches(data[i:i + 2]))) for i in (0, 2, 4)]
    module = PipelineModule(_torch_layers(False), num_stages=2, loss_fn=mse_loss,
                            partition_method="uniform")
    engine, _, _, _ = dt.initialize(model=module, config_params=_config(extra),
                                    device="cpu", **kw)
    got = [engine.train_batch(iter(_torch_batches(data[i:i + 2]))) for i in (0, 2, 4)]
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_pipeline_section_is_accepted_and_interleave_needs_divisible_micro_batches():
    module = PipelineModule(_torch_layers(False), num_stages=2, loss_fn=mse_loss)
    engine, _, _, _ = dt.initialize(model=module, config_params=_config(
        {"pipeline": {"executor": "auto", "partition_method": "uniform", "seed_layers": True,
                      "activation_checkpoint_interval": 0}}), device="cpu")
    assert engine.executor == "interpreted"
    assert np.isfinite(engine.train_batch(iter(_torch_batches(_data(2)))))
    module = PipelineModule(_torch_layers(False), num_stages=2, loss_fn=mse_loss)
    with pytest.raises(PipelineError, match=r"requires micro_batches \(3\) divisible by "
                                            r"pipeline stages \(2\)"):
        dt.initialize(model=module, config_params=_config(
            {"pipeline": {"num_model_chunks": 2}}, gas=3), device="cpu")


# ---------------------------------------------------------------------------
# port-only: restage, optimizer state, recompute == stored graph, rollback
# ---------------------------------------------------------------------------

def _gpt2_cfg(dropout=0.1):
    return dt.GPT2Config(vocab_size=256, hidden_size=32, num_hidden_layers=4,
                         num_attention_heads=2, max_position_embeddings=32,
                         hidden_dropout_prob=dropout, attention_probs_dropout_prob=dropout)


def _gpt2_data(n, seed=0):
    rng = np.random.RandomState(seed)
    return [(ids, ids) for ids in (torch.as_tensor(rng.randint(0, 16, (4, 16)))
                                   for _ in range(n))]


def _gpt2_engine(stages, base_seed=1234, extra=None):
    module = build_gpt2_pipeline(_gpt2_cfg(), num_stages=stages, base_seed=base_seed)
    cfg = {"train_batch_size": 8, "train_micro_batch_size_per_gpu": 4,
           "gradient_accumulation_steps": 2, "steps_per_print": 1000,
           "optimizer": {"type": "Adam", "params": {"lr": 1e-3}}}
    cfg.update(extra or {})
    engine, _, _, _ = dt.initialize(model=module, config_params=cfg, device="cpu")
    return engine


def test_restage_4_to_2_continues_bit_for_bit(tmp_path):
    data = _gpt2_data(8)
    ref = _gpt2_engine(4)
    it = iter(data)
    for _ in range(2):
        ref.train_batch(it)
    ref.save_checkpoint(str(tmp_path), tag="s2")
    saved_state = [[t.clone() for t in st.exp_avg + st.exp_avg_sq] for st in ref._opt_state]
    ref_losses = [ref.train_batch(it) for _ in range(2)]

    new = _gpt2_engine(2, base_seed=99)
    path, client = new.load_checkpoint(str(tmp_path))
    assert path.endswith("s2") and client == {} and new.global_steps == 2
    # the optimizer state round-trips, re-sliced onto 2 stages
    want_state = {n: (t[i], t[i + len(names)]) for names, t in zip(ref._names, saved_state)
                  for i, n in enumerate(names)}
    got_state = {n: (m, v) for names, st in zip(new._names, new._opt_state)
                 for n, m, v in zip(names, st.exp_avg, st.exp_avg_sq)}
    assert set(got_state) == set(want_state)
    for n, (m, v) in got_state.items():
        assert torch.equal(m, want_state[n][0]) and torch.equal(v, want_state[n][1]), n
    assert all(st.step == 2 for st in new._opt_state)
    it = iter(data[4:])
    losses = [new.train_batch(it) for _ in range(2)]
    assert losses == ref_losses
    for n, m in ref.master_params().items():
        assert torch.equal(new.master_params()[n], m), n


def test_zero_to_fp32_on_a_pipeline_tag_equals_the_layers(tmp_path):
    from deepspeed_tpu_torch.utils.zero_to_fp32 import convert_zero_checkpoint_to_fp32_state_dict

    engine = _gpt2_engine(2)
    engine.train_batch(iter(_gpt2_data(2)))
    engine.save_checkpoint(str(tmp_path))
    sd = get_fp32_state_dict_from_zero_checkpoint(str(tmp_path))
    want = engine._gather_layer_params()
    assert len(sd["layers"]) == len(want) == 7
    for got, layer in zip(sd["layers"], want):
        assert set(got) == set(layer)
        assert all(torch.equal(got[k], v) for k, v in layer.items())
    out = convert_zero_checkpoint_to_fp32_state_dict(str(tmp_path), str(tmp_path / "o.pt"))
    assert torch.load(tmp_path / "o.pt", weights_only=True)["layers"][1].keys() == \
        out["layers"][1].keys()


def _barrier_grads(engine, data_iter):
    """One step's schedule with the barrier's update swapped for a read of
    the gradients it would step on (averaged over the micro-batches, tied
    users summed into the owner), by parameter name; nothing is stepped."""
    got = {}

    def read():
        denom = engine.scaler_state.cur_scale * float(engine.micro_batches)
        got.update({n: a / denom for names, acc in zip(engine._names, engine._acc)
                    for n, a in zip(names, acc)})
        for acc in engine._acc:
            torch._foreach_zero_(acc)

    engine._update = read
    try:
        engine._run_schedule([engine._split_batch(next(data_iter))
                              for _ in range(engine.micro_batches)])
    finally:
        del engine._update
    return got


def test_recomputing_backward_equals_one_stored_graph():
    """Dropout 0.1 in attention (in the flash plain versions) and hidden
    states: the stage-by-stage recompute draws the forward's masks, so its
    gradients equal autograd through the whole model's stored graph."""
    engine = _gpt2_engine(3)
    data = _gpt2_data(2, seed=3)
    grads = _barrier_grads(engine, iter(data))
    m = engine.module
    names = [n for names in engine._names for n in names]
    params = [p for ps in engine._params for p in ps]
    acc = [torch.zeros_like(p) for p in params]
    for mb, (x, y) in enumerate(data):
        loss = m.loss_fn(m.forward(x, dropout_seed=engine._mb_seed(mb)), y).float()
        g = torch.autograd.grad(loss, params, allow_unused=True)
        torch._foreach_add_(acc, [torch.zeros_like(a) if t is None else t for a, t in zip(acc, g)])
    want = dict(zip(names, acc))
    for key, idxs in m.tied_specs.items():       # users' grads summed into the owner
        for user in idxs[1:]:
            for n in [n for n in names if n.startswith(f"layer_{user:02d}.")]:
                owner = n.replace(f"layer_{user:02d}.", f"layer_{idxs[0]:02d}.")
                want[owner] = want[owner] + want[n]
                want[n] = torch.zeros_like(want[n])
    assert set(grads) == set(want)
    for n, g in grads.items():
        assert torch.equal(g, want[n] / 2.0), n
    assert engine.global_steps == 0 and all(st is None for st in engine._opt_state)
    # the masks differ between micro-batches and layers (dropout is live)
    h = torch.randn(1, 16, 32, generator=torch.Generator().manual_seed(0))
    assert not torch.equal(m.apply_layer(1, h, dropout_seed=5), m.apply_layer(1, h, dropout_seed=6))


def test_nan_loss_at_step_2_rolls_back_to_the_clean_run(tmp_path):
    """The JAX ``test_resilience.py`` pipeline contract: a NaN loss injected
    at step 2 rolls back to the tag committed at step 2 and replays; the
    losses and masters end equal to an uninterrupted run's."""
    def run(resilience):
        extra = {}
        if resilience:
            extra["resilience"] = {"max_recoveries": 2, "recovery_backoff_s": 0,
                                   "fault_injection": {"nan_loss": {"at_step": 2}}}
        engine = _torch_engine(2, extra=extra)
        it = iter(_torch_batches(_data(STEPS * 2)))
        losses = []
        for _ in range(STEPS):
            losses.append(engine.train_batch(it))
            if resilience and engine.global_steps == 2:
                engine.save_checkpoint(str(tmp_path / "ck"))
        return engine, losses

    eng, losses = run(True)
    clean, clean_losses = run(False)
    assert eng.resilience.total_recoveries == 1
    assert eng.resilience.injector.fired.get("nan_loss") == 1
    assert losses == clean_losses
    for n, m in clean.master_params().items():
        assert torch.equal(eng.master_params()[n], m), n


def test_telemetry_spans_and_stage_gauges():
    from deepspeed_tpu_torch import telemetry

    engine = _torch_engine(2, extra={"telemetry": {"enabled": True}})
    try:
        engine.train_batch(iter(_torch_batches(_data(2))))
        names = {e["name"] for e in engine._tracer.events()}
        assert {"pipe/exec_schedule", "pipe/forward_pass", "pipe/backward_pass",
                "pipe/optimizer_step", "pipe/send_activation", "pipe/recv_grad"} <= names
        gauges = telemetry.get_registry().as_dict(pulled=False)
        assert gauges["Train/Pipe/stage0_time_ms"] > 0
        assert gauges["Train/Pipe/bubble_frac"] == pytest.approx(1 / 3)
        assert gauges["Train/Pipe/est_parallel_step_ms"] > 0
    finally:
        telemetry.configure(False)


# ---------------------------------------------------------------------------
# world 2 over gloo
# ---------------------------------------------------------------------------

def _train_world(rank, world):
    engine = _torch_engine(2, mb=GLOBAL_MB // world, world=world)
    rows = GLOBAL_MB // world
    data = [(torch.as_tensor(x[rank * rows:(rank + 1) * rows]),
             torch.as_tensor(y[rank * rows:(rank + 1) * rows])) for x, y in _data(6)]
    it = iter(data)
    losses = [engine.train_batch(it) for _ in range(3)]
    return losses, {k: v.clone() for k, v in engine.master_params().items()}


def _worker(rank, world, store_path, out_dir):
    torch.set_num_threads(1)
    torch.exp(torch.zeros(4))
    store = torch.distributed.FileStore(store_path, world)
    torch.distributed.init_process_group("gloo", store=store, rank=rank, world_size=world)
    torch.save(_train_world(rank, world), os.path.join(out_dir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


def test_world2_gloo_equals_world1(tmp_path):
    ctx = mp.start_processes(_worker, args=(2, str(tmp_path / "store"), str(tmp_path)),
                             nprocs=2, join=False, start_method="spawn")
    deadline = time.monotonic() + TIMEOUT_S
    while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"world-2 pipeline run did not finish within {TIMEOUT_S} s")
    got = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]
    want_losses, want_masters = _train_world(0, 1)
    np.testing.assert_allclose(np.mean([g[0] for g in got], axis=0), want_losses, rtol=1e-5)
    for k, want in want_masters.items():
        assert torch.equal(got[0][1][k], got[1][1][k]), k
        torch.testing.assert_close(got[0][1][k], want, rtol=0, atol=1e-5, msg=k)
