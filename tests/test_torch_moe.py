"""Mixture-of-Experts and expert parallelism of the port against the JAX
package (``deepspeed_tpu/parallel/expert.py``).

- ``top1_gating``'s dispatch and combine equal JAX's exactly, and its aux
  loss to 1e-6;
- ``moe_ffn`` (the tanh GELU of ``jax.nn.gelu``) equals JAX's within 1e-4,
  gradients of every parameter too;
- ``expert_parallel_ffn`` at world 2 over gloo (8 experts, 4 a rank, one
  all-to-all each way) equals JAX's ``shard_map`` version on a 2-device
  mesh within 1e-4 (``tests/unit/test_moe.py:174-175``), aux loss too;
- ``MoELayer`` inside a model trains through ``initialize()`` (the aux
  loss in the training loss, the loss falls), as
  ``tests/unit/test_moe.py:108-142``; the DTensor placements of
  ``expert_shardings`` split a complete MoE group only.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.sharding import Mesh, PartitionSpec  # noqa: E402

import deepspeed_tpu_torch as dt  # noqa: E402
from deepspeed_tpu.parallel import expert as J  # noqa: E402
from deepspeed_tpu.utils.shard_map_compat import shard_map  # noqa: E402
from deepspeed_tpu_torch.parallel import expert as T  # noqa: E402
from tests import torch_parallel_workers as W  # noqa: E402
from tests.unit.test_moe import _params  # noqa: E402

_NP = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
_T = lambda tree: {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


@pytest.mark.parametrize("T_,E,C", [(64, 4, 8), (32, 8, 2), (48, 4, 16)])
def test_top1_gating_equals_jax(T_, E, C):
    logits = np.asarray(jax.random.normal(jax.random.PRNGKey(T_ + E), (T_, E)))
    jd, jc, ja = J.top1_gating(jnp.asarray(logits), C)
    td, tc, ta = T.top1_gating(torch.from_numpy(logits), C)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6)


def test_moe_ffn_and_grads_equal_jax():
    params = _NP(_params(3, 4, 16, 32))
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(4), (64, 16)))

    def jloss(p, x):
        out, aux = J.moe_ffn(p, x, 16)
        return jnp.sum(out ** 2) + aux

    jout, jaux = J.moe_ffn(params, jnp.asarray(x), 16)
    jg = jax.grad(jloss)(params, jnp.asarray(x))
    tp = {k: v.requires_grad_() for k, v in _T(params).items()}
    out, aux = T.moe_ffn(tp, torch.from_numpy(x), 16)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    ((out ** 2).sum() + aux).backward()
    for k in params:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jg[k]), atol=1e-4,
                                   rtol=1e-4, err_msg=k)


def test_expert_parallel_at_world2_equals_jax_shard_map(tmp_path):
    Wn, E, d, f, Tn, cap = 2, 8, 16, 32, 64, 12
    params = _NP(_params(4, E, d, f))
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(5), (Tn, d), jnp.float32))
    mesh = Mesh(np.asarray(jax.devices()[:Wn]), ("data",))
    P = PartitionSpec
    fn = shard_map(lambda p, xx: J.expert_parallel_ffn(p, xx, cap, "data"), mesh=mesh,
                   in_specs=({"router": P(), "w1": P("data", None, None), "b1": P("data", None),
                              "w2": P("data", None, None), "b2": P("data", None)},
                             P("data", None)),
                   out_specs=(P("data", None), P()))
    jout, jaux = jax.jit(fn)(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    ranks = W.spawn(W.moe_worker, Wn, tmp_path, dict(params=params, x=x, capacity=cap))
    got = torch.cat([r["out"] for r in ranks]).numpy()
    np.testing.assert_allclose(got, np.asarray(jout), atol=1e-4, rtol=1e-4)
    for r in ranks:
        np.testing.assert_allclose(r["aux"], float(jaux), rtol=1e-5)
        assert r["w1_grad_finite"] and r["w1_local"] == (E // Wn, d, f)


class TinyMoEModel(torch.nn.Module):
    """Dense(8 -> 16), MoELayer(4 experts), Dense(16 -> 4); MSE plus 0.01
    times the aux loss (``tests/unit/test_moe.py:115-120``)."""

    def __init__(self):
        super().__init__()
        torch.manual_seed(0)
        self.inp = torch.nn.Linear(8, 16)
        self.moe = T.MoELayer(T.MoEConfig(num_experts=4, d_model=16, d_ff=32))
        self.out = torch.nn.Linear(16, 4)

    def forward(self, x, y):
        h, aux = self.moe(self.inp(x))
        return ((self.out(h) - y) ** 2).mean() + 0.01 * aux


def test_moe_layer_trains_through_initialize():
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(8, 8, 8).astype(np.float32))
    y = torch.from_numpy(rng.randn(8, 8, 4).astype(np.float32))
    engine, _, _, _ = dt.initialize(model=TinyMoEModel(), config={
        "train_batch_size": 8, "optimizer": {"type": "Adam", "params": {"lr": 1e-2}}},
        device="cpu")
    losses = []
    for _ in range(8):
        loss = engine(x, y)
        engine.backward(loss)
        engine.step()
        losses.append(float(loss))
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses


def test_expert_shardings_split_only_a_moe_group():
    from torch.distributed.tensor import Replicate, Shard

    params = _NP(_params(7, 8, 16, 32))
    sh = T.expert_shardings(None, params)
    assert sh["router"] == (Replicate(),) * 3
    assert sh["w1"] == (Replicate(), Shard(0), Replicate())
    tree = {"moe": params, "dense": {"w1": np.zeros((6, 4)), "w2": np.zeros((4, 6))}}
    sh2 = T.expert_shardings(None, tree)
    assert sh2["dense"]["w1"] == (Replicate(),) * 3
    assert sh2["moe"]["w2"] == (Replicate(), Shard(0), Replicate())


def _jax_moe_model():
    """The flax model of ``tests/unit/test_moe.py:108-142`` and its data
    (B = 8 rows of 8 tokens), with its initial parameters."""
    import flax.linen as nn

    class TinyMoE(nn.Module):
        @nn.compact
        def __call__(self, x, y):
            h = nn.Dense(16)(x)
            h, aux = J.MoELayer(J.MoEConfig(num_experts=4, d_model=16, d_ff=32))(h)
            logits = nn.Dense(4)(h)
            return jnp.mean((logits - y) ** 2) + 0.01 * aux

    rng = np.random.RandomState(0)
    x = rng.randn(8, 8, 8).astype(np.float32)
    y = rng.randn(8, 8, 4).astype(np.float32)
    model = TinyMoE()
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(y))
    return model, params, x, y


def test_moe_model_of_the_jax_engine_test_matches_jax_losses():
    """``test_moe_layer_trains_through_engine``'s model and data through
    both engines from the same weights: the JAX engine data-parallel on its
    8 virtual devices, the port at world 1; 8 Adam steps, losses 1e-5."""
    import deepspeed_tpu

    model, params, x, y = _jax_moe_model()
    np_params = _NP(params)               # the engine donates its buffers
    B = x.shape[0]
    engine, _, _, _ = deepspeed_tpu.initialize(
        model=model, model_parameters=params,
        config_params={"train_batch_size": B,
                       "train_micro_batch_size_per_gpu": B // len(jax.devices()),
                       "optimizer": {"type": "Adam", "params": {"lr": 1e-2}}})
    want = []
    for _ in range(8):
        loss = engine(jnp.asarray(x), jnp.asarray(y))
        engine.backward(loss)
        engine.step()
        want.append(float(jax.device_get(loss)))
    got = W.moe_engine_run(dict(params=np_params, x=x, y=y, steps=8))["losses"]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[-1] < got[0]


def test_expert_parallel_moe_under_initialize_at_world2_equals_world1(tmp_path):
    """The experts split over 2 gloo ranks (2 of 4 a rank, each rank on half
    the batch) train as the whole layer on the whole batch at world 1: the
    expert gradients are not averaged over the data group but scaled by
    1 / 2, every other gradient averaged. Capacity 4 x the even share, so
    no token drops, and no aux loss (a per-rank aux loss averaged over the
    ranks is not the global one); losses and masters within 1e-6."""
    _, params, x, y = _jax_moe_model()
    spec = dict(params=_NP(params), x=x, y=y, steps=4,
                net=dict(capacity_factor=4.0, aux_weight=0.0))
    ranks = W.spawn(W.moe_engine_worker, 2, tmp_path, spec)
    want = W.moe_engine_run(spec)
    np.testing.assert_allclose(np.mean([r["losses"] for r in ranks], axis=0), want["losses"],
                               rtol=1e-6)
    for k, v in want["masters"].items():
        for r in ranks:
            torch.testing.assert_close(r["masters"][k], v, rtol=0, atol=1e-6, msg=k)


def test_expert_parallel_moe_with_zero_is_refused_by_name(tmp_path):
    """ZeRO with split experts is queued (ROADMAP.md): refused at build."""
    _, params, x, y = _jax_moe_model()
    model = W.MoENet(_NP(params))
    model.moe.group = object()          # stands in for a group of two ranks
    original = T.comm.group_size
    T.comm.group_size = lambda g: 2 if g is model.moe.group else original(g)
    try:
        with pytest.raises(NotImplementedError, match=r"ZeRO \(zero_optimization.stage > 0\) "
                                                      "with an expert-parallel MoELayer"):
            dt.initialize(model=model, config={
                "train_batch_size": 8, "zero_optimization": {"stage": 1},
                "optimizer": {"type": "Adam", "params": {"lr": 1e-2}}}, device="cpu")
    finally:
        T.comm.group_size = original
