"""The port's data parallelism at world 2, on the CPU over gloo.

Two processes started by ``torch.multiprocessing`` meet in a
``FileStore`` under the test's directory (no TCP port) and train tiny
BERT (2 layers, hidden 64, dropout off, fp32) on their halves of one
global batch; the same steps at world 1 on the whole batch are the
reference. Every row of the batch carries the same number of MLM labels,
so the mean of the two halves' losses is the whole batch's loss.

Tolerances: losses 1e-5 relative (measured 8.3e-8), masters 1e-5
absolute after three steps of lr 1e-3 (fp32; the two ranks' mean
gradient and the whole batch's gradient are the same sums in another
order, and Adam's first steps move a weight by about lr whatever the
gradient's size, so an element whose gradient is within rounding of zero
may move apart by up to 2 lr; measured 2.8e-6). A run with
``overlap_comm`` (one all-reduce a bucket, from the backward's gradient
hooks) equals the run without it bit for bit. Each world-2 test waits at
most ``TIMEOUT_S`` for its processes.
"""

import os
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import deepspeed_tpu_torch as dt
from deepspeed_tpu_torch.models.bert import BertConfig, bert_init_plan
from deepspeed_tpu_torch.utils import distributed as tdist

SEQ = 128
TIMEOUT_S = 120
LOSS_RTOL = 1e-5
MASTER_ATOL = 1e-5


def _cfg(**kw):
    return BertConfig(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                      num_attention_heads=2, intermediate_size=128,
                      max_position_embeddings=SEQ, hidden_dropout_prob=0.0,
                      attention_probs_dropout_prob=0.0, **kw)


def _global_batch(seed=0, rows=4):
    """``rows`` rows with 12 MLM labels each."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 256, (rows, SEQ))
    labels = np.full((rows, SEQ), -1)
    for r in range(rows):
        pos = rng.choice(SEQ, 12, replace=False)
        labels[r, pos] = rng.randint(0, 256, 12)
    nsp = rng.randint(0, 2, (rows,))
    return tuple(torch.as_tensor(x) for x in (ids, np.zeros_like(ids), np.ones_like(ids),
                                              labels, nsp))


def _ds_config(world, **kw):
    cfg = {"train_batch_size": 4, "train_micro_batch_size_per_gpu": 4 // world,
           "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
           "gradient_clipping": 1.0, "activation_checkpointing": {"enabled": True}}
    cfg.update(kw)
    return cfg


def _train(config, rank, world, steps=3, model_kw=None, sharded_init=False):
    """Losses and final masters of ``steps`` train steps of this rank's
    rows of the global batch."""
    if sharded_init:
        cfg = _cfg(**(model_kw or {}))
        model = dt.zero3_sharded_init(lambda: dt.BertForPreTraining(cfg), bert_init_plan,
                                      seed=0, device="cpu")
    else:
        model = dt.init_bert(_cfg(**(model_kw or {})), seed=0, device="cpu")
    engine, _, _, _ = dt.initialize(model=model, config=_ds_config(world, **config),
                                    device="cpu")
    rows = 4 // world
    batch = tuple(x[rank * rows:(rank + 1) * rows] for x in _global_batch())
    losses = [float(engine.train_step([batch])) for _ in range(steps)]
    if engine.zero_optimization_stage() == 3 and world > 1:   # stored as shards
        shards = [p for p in engine.module.parameters() if p.shape[0] != p.ds_shape[0]]
        assert shards and all(2 * p.shape[0] == p.ds_shape[0] for p in shards)
    return losses, {k: v.clone() for k, v in engine.master_params().items()}


# (name, config, engine kwargs) of each run a world-2 test makes
RUNS = {
    "stage2": [("adam", {"zero_optimization": {"stage": 2}}, {}),
               ("overlap", {"zero_optimization": {"stage": 2, "overlap_comm": True,
                                                  "reduce_bucket_size": 20000}}, {}),
               ("lamb", {"zero_optimization": {"stage": 2},
                         "optimizer": {"type": "Lamb", "params": {"lr": 1e-2}}}, {})],
    "stage3": [("dots", {"zero_optimization": {"stage": 3}},
                {"model_kw": {"checkpoint_activations": True, "checkpoint_policy": "dots"}}),
               ("sharded_init", {"zero_optimization": {"stage": 3}}, {"sharded_init": True})],
    "stage0": [("allreduce", {"zero_optimization": {"stage": 0}}, {})],
}


def _worker(rank, world, store_path, out_dir, runs, from_env):
    torch.set_num_threads(1)
    if from_env:   # the launcher's environment, read by init_distributed
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world))
        dt.init_distributed(init_method=f"file://{store_path}", device_type="cpu",
                            verbose=False)
    else:
        store = torch.distributed.FileStore(store_path, world)
        torch.distributed.init_process_group("gloo", store=store, rank=rank,
                                             world_size=world)
    out = {"rank": tdist.get_rank(), "world": tdist.get_world_size()}
    for name, config, kw in RUNS[runs]:
        out[name] = _train(config, rank, world, **kw)
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


def _run_world2(tmp_path, runs, from_env=False):
    ctx = mp.start_processes(_worker, args=(2, str(tmp_path / "store"), str(tmp_path), runs,
                                            from_env),
                             nprocs=2, join=False, start_method="spawn")
    deadline = time.monotonic() + TIMEOUT_S
    while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"world-2 run '{runs}' did not finish within {TIMEOUT_S} s")
    return [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]


def _held(ranks, runs):
    for name, config, kw in RUNS[runs]:
        want_losses, want_master = _train(config, 0, 1, **kw)
        got = [r[name] for r in ranks]
        got_losses = np.mean([g[0] for g in got], axis=0)
        np.testing.assert_allclose(got_losses, want_losses, rtol=LOSS_RTOL, err_msg=name)
        assert want_losses[-1] < want_losses[0]
        for k, want in want_master.items():
            # every rank holds the same whole master after the gather
            torch.testing.assert_close(got[0][1][k], got[1][1][k], rtol=0, atol=0)
            torch.testing.assert_close(got[0][1][k], want, rtol=0, atol=MASTER_ATOL,
                                       msg=f"{name}: {k}")


def test_zero2_world2_equals_world1(tmp_path):
    """Stage 2 (reduce-scatter, the slice's Adam, all-gather), the same with
    ``overlap_comm``, and LAMB at stage 2, whose one trust ratio is over
    the whole flat master: its squared norms are summed over the ranks."""
    ranks = _run_world2(tmp_path, "stage2")
    _held(ranks, "stage2")
    for r in ranks:
        assert r["overlap"][0] == r["adam"][0]
        for k, v in r["adam"][1].items():
            assert torch.equal(r["overlap"][1][k], v), k


def test_zero3_world2_with_recompute_equals_world1(tmp_path):
    """Stage 3 with "dots" activation checkpointing (the recompute reads
    the parameters gathered for the step), and a model built by
    ``zero3_sharded_init`` with its parameters born as shards."""
    _held(_run_world2(tmp_path, "stage3"), "stage3")


def test_stage0_gradient_allreduce_world2_equals_world1(tmp_path):
    """Stage 0 all-reduces the accumulated gradients to their mean; the
    group is started by ``init_distributed`` from RANK / WORLD_SIZE."""
    ranks = _run_world2(tmp_path, "stage0", from_env=True)
    assert [(r["rank"], r["world"]) for r in ranks] == [(0, 2), (1, 2)]
    _held(ranks, "stage0")


def test_init_distributed_is_a_noop_for_one_process(monkeypatch):
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "OMPI_COMM_WORLD_RANK", "PMI_RANK"):
        monkeypatch.delenv(key, raising=False)
    dt.init_distributed(device_type="cpu", verbose=False)
    assert not torch.distributed.is_initialized()
    assert (tdist.get_rank(), tdist.get_world_size()) == (0, 1)
    assert tdist.group_rank_and_size() == (0, 1)
    monkeypatch.setenv("WORLD_SIZE", "1")
    dt.init_distributed(device_type="cpu", verbose=False)
    assert not torch.distributed.is_initialized()


def test_init_distributed_starts_a_group_when_asked(tmp_path, monkeypatch):
    """With an ``init_method`` a one-process group starts (gloo on the
    CPU) from RANK / WORLD_SIZE, and a second call leaves it as it is."""
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert tdist._required_env_set() is False
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    assert tdist._required_env_set() is True
    assert tdist._in_mpi_env() is False
    url = f"file://{tmp_path / 'store'}"
    dt.init_distributed(init_method=url, device_type="cpu", verbose=False)
    try:
        assert torch.distributed.is_initialized()
        assert torch.distributed.get_backend() == "gloo"
        assert tdist.group_rank_and_size() == (0, 1)
        dt.init_distributed(init_method=url, device_type="cpu", verbose=False)
    finally:
        torch.distributed.destroy_process_group()
