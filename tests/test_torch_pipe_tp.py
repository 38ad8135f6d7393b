"""ZeRO and tensor parallelism under the port's pipeline against the JAX
package (``tests/unit/test_pipe.py:226-310``).

One world-4 gloo run (``tests/torch_parallel_workers.py``; each process a
(data, model) rank driving both stages, the data ranks taking their rows
of every global micro-batch) trains, from the JAX modules' initial
weights:

- the MLP pipeline of ``make_module(2)`` with ZeRO-1 at data 4, against
  JAX's ZeRO-1 pipe on its 8 virtual devices (data 4 a stage): losses at
  JAX's ``rtol=2e-4``;
- the ``TPBlock`` pipeline (ff1 by columns, ff2 by rows) at tensor_parallel
  2 x data 2, without ZeRO, with ZeRO-1 (built from ``mpu=``) and with
  ZeRO-2, against JAX's pp2 x dp2 x tp2 run: losses at ``rtol=2e-4``; the
  stage layers are Megatron layers;
- the ZeRO-1 TP run saves a tag after 2 of 4 steps: a fresh engine loads
  it bit for bit and its last 2 steps equal the uninterrupted run's; the
  tag holds whole tensors, so ``zero_to_fp32`` reads the masters bit for
  bit and the tag loads at world 1 without ZeRO or TP.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import deepspeed_tpu  # noqa: E402
import deepspeed_tpu_torch as dt  # noqa: E402
from deepspeed_tpu_torch.runtime.pipe.module import LayerSpec, PipelineModule  # noqa: E402
from deepspeed_tpu_torch.utils.zero_to_fp32 import (  # noqa: E402
    get_fp32_state_dict_from_zero_checkpoint,
)
from tests import torch_parallel_workers as W  # noqa: E402
from tests.unit import test_pipe as JP  # noqa: E402

_NP = lambda tree: None if tree is None else jax.tree_util.tree_map(np.asarray, tree)
STEPS = 4


def _jax_run(module, cfg, data):
    init = [_NP(p) for p in module.init_params(jnp.zeros((1, JP.HIDDEN), jnp.float32))]
    engine, _, _, _ = deepspeed_tpu.initialize(model=module, config_params=cfg)
    it = iter(data)
    return init, [engine.train_batch(it) for _ in range(STEPS)]


def _tp_module():
    return JP.PipelineModule([JP.LayerSpec(JP.TPBlock) for _ in range(4)], num_stages=2,
                             loss_fn=JP.mse_loss, base_seed=11, partition_method="uniform")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipe_tp")
    mlp_data = JP.make_data(8, 32)
    tp_data = JP.make_data(8, 8, seed=4)
    zero_cfg = dict(JP.ds_config(mb=8, gas=2, dp=4), zero_optimization={"stage": 1})
    mlp_init, zero_losses = _jax_run(JP.make_module(2), zero_cfg, mlp_data)
    tp_cfg = dict(JP.ds_config(mb=4, gas=2, dp=2), tensor_parallel={"size": 2})
    tp_init, tp_losses = _jax_run(_tp_module(), tp_cfg, tp_data)
    base = JP.ds_config(mb=4, gas=2, dp=2)
    tp_run = dict(layers=["tp"] * 4, init=tp_init, data=tp_data, tp=2, steps=STEPS)
    spec = {
        "zero1_dp4": dict(layers=["dense", "relu"] * 4, init=mlp_init, data=mlp_data, tp=1,
                          steps=STEPS, config=zero_cfg),
        "tp2": dict(tp_run, config=base),
        "tp2_zero1": dict(tp_run, config=dict(base, zero_optimization={"stage": 1}),
                          mpu=True, save_at=2),
        "tp2_zero2": dict(tp_run, config=dict(base, zero_optimization={"stage": 2})),
    }
    got = W.spawn(W.pipe_tp_worker, 4, tmp, spec, str(tmp / "ckpt"))
    return dict(got=got, zero_losses=zero_losses, tp_losses=tp_losses, tp_init=tp_init,
                ckpt=tmp / "ckpt" / "tp2_zero1")


def _mean_over_data(got, name, tp):
    """The global loss: the mean of the data ranks' (a model group's ranks
    report the same loss)."""
    ranks = [got[r][name]["losses"] for r in range(0, len(got), tp)]
    for r in range(len(got)):
        np.testing.assert_array_equal(got[r][name]["losses"], got[r - r % tp][name]["losses"])
    return np.mean(ranks, axis=0)


def test_zero1_pipe_matches_jax(runs):
    np.testing.assert_allclose(_mean_over_data(runs["got"], "zero1_dp4", 1),
                               runs["zero_losses"], rtol=2e-4)


@pytest.mark.parametrize("name", ["tp2", "tp2_zero1", "tp2_zero2"])
def test_tensor_parallel_pipe_matches_jax(runs, name):
    np.testing.assert_allclose(_mean_over_data(runs["got"], name, 2), runs["tp_losses"],
                               rtol=2e-4)
    masters = [runs["got"][r][name]["masters"] for r in range(4)]
    for k, v in masters[0].items():
        for m in masters[1:]:
            assert torch.equal(m[k], v), k


def test_stage_layers_are_megatron_layers(runs):
    types = runs["got"][0]["tp2"]["types"]
    assert {"ColumnParallelLinear", "RowParallelLinear"} <= set(types)
    assert "Linear" not in types
    assert "Linear" in runs["got"][0]["zero1_dp4"]["types"]


def test_zero1_tp_pipe_tag_round_trips_and_loads_at_world_1(runs):
    for r in range(4):
        out = runs["got"][r]["tp2_zero1"]
        for k, v in out["saved"].items():
            assert torch.equal(out["loaded"][k], v), k
        np.testing.assert_array_equal(out["resumed"], out["losses"][2:])
        for k, v in out["masters"].items():
            assert torch.equal(out["resumed_masters"][k], v), k
    saved = runs["got"][0]["tp2_zero1"]["saved"]
    layers = get_fp32_state_dict_from_zero_checkpoint(str(runs["ckpt"]), tag="t")["layers"]
    fp32 = {f"layer_{i:02d}.{k}": v for i, layer in enumerate(layers) if layer
            for k, v in layer.items()}
    assert set(fp32) == set(saved)
    for k, v in saved.items():
        assert torch.equal(fp32[k], v), k
    module = PipelineModule([LayerSpec(W.TPBlock) for _ in range(4)], num_stages=2,
                            loss_fn=W._pipe_mse, partition_method="uniform")
    engine, _, _, _ = dt.initialize(model=module, config_params=JP.ds_config(mb=8, gas=2),
                                    device="cpu")
    engine.load_checkpoint(str(runs["ckpt"]), tag="t")
    for k, v in engine.master_params().items():
        assert torch.equal(v, saved[k]), k
