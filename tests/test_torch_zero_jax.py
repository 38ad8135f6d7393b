"""The port's ZeRO engine against the JAX engine at the same stage.

Tiny BERT (2 layers, hidden 64, sequence 128 so the attention runs the
flash kernels' plain versions) through ``initialize()`` on the CPU, beside
``deepspeed_tpu.initialize`` on a mesh of one device, from the same
weights (``from_jax_params``) over the same samples (``training_data=``,
``train_batch()``). Tolerances: bf16 Adam losses 2e-3 relative (bf16
rounds in another order on the two sides; test_torch_fp16.py measured
3.2e-4 without ZeRO); fp16 with dynamic loss scaling, LAMB and
WarmupDecayLR 1e-4 relative (test_torch_fp16.py measured 1.4e-5); the
overflow steps, loss scale, skipped steps and LR exactly.
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
from deepspeed_tpu_torch.models.bert import BertConfig, BertForPreTraining  # noqa: E402

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


def _tcfg(jcfg):
    d = dataclasses.asdict(jcfg)
    d.pop("scan_unroll")
    return BertConfig(**d)


@pytest.fixture(scope="module")
def bert():
    jcfg = _jcfg()
    batch = _bert_batch(2, SEQ, 256, 0)
    params = JBert(jcfg).init({"params": jax.random.PRNGKey(0),
                               "dropout": jax.random.PRNGKey(1)},
                              *(jnp.asarray(x) for x in batch))
    return jcfg, params


def _dataset(n, seed):
    cols = _bert_batch(n, SEQ, 256, seed)
    return [tuple(c[i] for c in cols) for i in range(n)]


BF16_ADAM = {"train_batch_size": 4, "bf16": {"enabled": True},
             "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
             "gradient_clipping": 1.0, "activation_checkpointing": {"enabled": True}}

FP16_LAMB = {"train_batch_size": 4,
             "fp16": {"enabled": True, "initial_scale_power": 24, "hysteresis": 1,
                      "loss_scale_window": 3},
             "optimizer": {"type": "Lamb", "params": {"lr": 1e-2, "weight_decay": 0.01}},
             "gradient_clipping": 1.0,
             "scheduler": {"type": "WarmupDecayLR",
                           "params": {"warmup_num_steps": 4, "total_num_steps": 30,
                                      "warmup_max_lr": 1e-2}},
             "activation_checkpointing": {"enabled": True}}


def _trajectories(bert, config, steps):
    """Each engine's per-step (loss, loss scale, skipped steps, LR) over
    ``train_batch()`` on its own loader of the same samples."""
    jcfg, params = bert
    data = _dataset(8, seed=3)
    jeng, _, _, _ = deepspeed_tpu.initialize(
        model=JBert(_jcfg()), model_parameters=jax.tree_util.tree_map(jnp.array, params),
        config_params=dict(config, mesh={"data_parallel_size": 1}), training_data=data)
    teng, _, _, _ = dt.initialize(
        model=BertForPreTraining.from_jax_params(_TO_NP(params), _tcfg(jcfg)),
        config=config, training_data=data, device="cpu")
    runs = []
    for eng in (jeng, teng):
        rows = []
        for _ in range(steps):
            lr = eng.get_lr()[0]
            rows.append((eng.train_batch(), eng.loss_scale(), eng.skipped_steps, lr))
        runs.append(rows)
    return runs


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_zero_bf16_adam_trajectory_matches_jax(bert, stage):
    config = dict(BF16_ADAM, zero_optimization={"stage": stage})
    want, got = _trajectories(bert, config, 6)
    np.testing.assert_allclose([r[0] for r in got], [r[0] for r in want], rtol=2e-3)
    assert [r[1:] for r in got] == [r[1:] for r in want]
    assert got[-1][0] < got[0][0]


def test_zero2_fp16_lamb_dynamic_scale_trajectory_matches_jax(bert):
    """fp16 with dynamic loss scaling from 2^24 (overflow skips, then
    growth), LAMB with its one trust ratio over the flat master, gradient
    clipping and WarmupDecayLR, at stage 2, step for step."""
    config = dict(FP16_LAMB, zero_optimization={"stage": 2})
    want, got = _trajectories(bert, config, 14)
    np.testing.assert_allclose([r[0] for r in got], [r[0] for r in want], rtol=1e-4)
    assert [r[1:] for r in got] == [r[1:] for r in want]
    skipped = [r[2] for r in got]
    assert skipped[0] == 1 and 1 < skipped[-1] < 14
    assert got[-1][0] < got[0][0]
