"""The port's checkpoint save and resume, on the CPU.

Tiny BERT (``_tiny_bert_config()``: 2 layers, hidden 64; sequence 128 so
the attention runs the flash kernels' plain versions; dropout 0.1 so the
step's random stream matters) through ``initialize(..., device="cpu")``,
a new batch every step and a WarmupLR schedule whose LR moves every
step. Tolerances: none. A run saved after K steps and resumed in a fresh
engine from another init seed gives the uninterrupted run's losses, fp32
masters, module weights, loss scale, LR and skipped steps bit for bit, at
ZeRO stages 0-3 in bf16 and fp16 (and fp32), and under ZeRO-Offload
sequential and streamed. The fault cases (``@pytest.mark.faults``) are
the JAX package's suite, ``tests/unit/test_checkpointing.py``, on the
port's engine; the copied storage modules are held against the JAX
package's on the same inputs. Saves and loads across dp degrees are in
test_torch_elastic.py, the consolidation and the trajectories against the
JAX engine in test_torch_zero_to_fp32.py.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

import deepspeed_tpu_torch as dt  # noqa: E402
from __graft_entry__ import _bert_batch, _tiny_bert_config  # noqa: E402
from deepspeed_tpu.runtime import checkpoint as jckpt  # noqa: E402
from deepspeed_tpu_torch.runtime.checkpoint import manifest as tmanifest  # noqa: E402
from deepspeed_tpu_torch.runtime.checkpoint import (  # noqa: E402
    MANIFEST_NAME,
    CheckpointCorruptionError,
    CheckpointStorage,
    FaultInjector,
    InjectedCrash,
    TagWatcher,
    latest_committed_tag,
    read_manifest,
)

SEQ = 128
K = 3


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Tiny tensors gain nothing from many threads; the test workers
    share the machine."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _model_config():
    d = dataclasses.asdict(_tiny_bert_config())
    d.pop("scan_unroll")
    d.update(max_position_embeddings=SEQ, hidden_dropout_prob=0.1,
             attention_probs_dropout_prob=0.1)
    return dt.BertConfig(**d)


def _config(stage=0, dtype="bf16", scale_power=24, **kw):
    cfg = {"train_batch_size": 4, "steps_per_print": 1000,
           "optimizer": {"type": "Adam", "params": {"lr": 1e-3, "weight_decay": 0.01}},
           "scheduler": {"type": "WarmupLR",
                         "params": {"warmup_min_lr": 0, "warmup_max_lr": 1e-3,
                                    "warmup_num_steps": 10}},
           "zero_optimization": {"stage": stage}}
    if dtype == "fp16":
        # overflow skips at the start, then growth every 2 clean steps
        cfg["fp16"] = {"enabled": True, "initial_scale_power": scale_power, "hysteresis": 1,
                       "loss_scale_window": 2}
    elif dtype == "bf16":
        cfg["bf16"] = {"enabled": True}
    cfg.update(kw)
    return cfg


def _engine(config, seed=0):
    model = dt.init_bert(_model_config(), seed=seed, device="cpu")
    engine, _, _, _ = dt.initialize(model=model, config=config, device="cpu")
    return engine


def _batch(step):
    return tuple(torch.from_numpy(x) for x in _bert_batch(4, SEQ, 256, 100 + step))


def _train(engine, steps, start):
    """``steps`` steps on the batches of steps ``start``, ``start + 1``..."""
    return [float(engine.train_step([_batch(start + i)])) for i in range(steps)]


def _masters(engine):
    return {k: v.clone() for k, v in engine.master_params().items()}


def _weights(engine):
    return {k: p.detach().clone() for k, p in engine.module.named_parameters()}


def _counters(engine):
    return (engine.global_steps, engine.global_samples, engine.skipped_steps,
            engine.loss_scale(), engine.get_lr())


def _assert_equal(got, want):
    assert list(got) == list(want)
    for k, w in want.items():
        assert torch.equal(got[k], w), k


def _close(*engines):
    for e in engines:
        close = getattr(e.optimizer, "close", None)
        if close is not None:
            close()


def _resume_check(tmp_path, save_cfg, load_cfg=None):
    """Save after K steps, then K more steps in the saving engine and in a
    fresh engine (init seed 99) that loaded the tag: everything equal."""
    save_dir = str(tmp_path / "ckpt")
    a = _engine(save_cfg)
    _train(a, K, 0)
    a.save_checkpoint(save_dir)
    saved = (_masters(a), _weights(a), _counters(a))
    want = _train(a, K, K)
    b = _engine(load_cfg or save_cfg, seed=99)
    assert not torch.equal(b.master_params()["bert.embeddings.word_embeddings.weight"],
                           saved[0]["bert.embeddings.word_embeddings.weight"])
    name, client = b.load_checkpoint(save_dir)
    assert name.endswith(os.path.join(f"global_step{K}", "mp_rank_00_model_states.pt"))
    assert client == {}
    _assert_equal(_masters(b), saved[0])
    _assert_equal(_weights(b), saved[1])
    assert _counters(b) == saved[2]
    got = _train(b, K, K)
    assert got == want
    _assert_equal(_masters(b), _masters(a))
    _assert_equal(_weights(b), _weights(a))
    assert _counters(b) == _counters(a)
    return a, b


@pytest.mark.parametrize("stage,dtype", [
    (0, "fp32"), (0, "bf16"), (0, "fp16"), (1, "bf16"), (1, "fp16"),
    (2, "fp32"), (2, "bf16"), (2, "fp16"), (3, "bf16"), (3, "fp16")])
def test_resume_equals_uninterrupted_bit_for_bit(tmp_path, stage, dtype):
    a, _ = _resume_check(tmp_path, _config(stage, dtype))
    if dtype == "fp16":
        assert a.skipped_steps > 0


@pytest.mark.parametrize("save_k,load_k,dtype", [
    (1, 1, "bf16"), (4, 4, "bf16"), (4, 1, "bf16"), (1, 4, "fp16")])
def test_offload_resume_bit_for_bit(tmp_path, save_k, load_k, dtype):
    """ZeRO-2 + cpu_offload, sequential (1 bucket) or streamed (4): the
    host master, the host Adam's moments and its step come back exactly,
    into a streamed or a sequential engine."""
    cfg = lambda k: _config(2, dtype, scale_power=12, zero_optimization={
        "stage": 2, "cpu_offload": True, "offload_stream_buckets": k})
    save_dir = str(tmp_path / "ckpt")
    a = _engine(cfg(save_k))
    _train(a, K, 0)
    a.save_checkpoint(save_dir)
    host = a.optimizer._host_inner
    saved = (host.step, host.exp_avg.clone(), host.exp_avg_sq.clone())
    b = _engine(cfg(load_k), seed=99)
    b.load_checkpoint(save_dir)
    got = b.optimizer._host_inner
    assert got.step == saved[0] > 0
    assert torch.equal(got.exp_avg, saved[1]) and torch.equal(got.exp_avg_sq, saved[2])
    assert b.optimizer._offload_master_next is None
    want = _train(a, K, K)
    assert _train(b, K, K) == want
    _assert_equal(_masters(b), _masters(a))
    _assert_equal(_weights(b), _weights(a))
    _close(a, b)


def test_stage2_tag_resumes_under_offload_and_back(tmp_path):
    """The device and host shards have one format: a ZeRO-2 tag resumes
    under offload and an offload tag at plain ZeRO-2, masters and Adam
    moments exactly; the next step's loss within 1e-6 (the host kernel
    and the device Adam round in another order)."""
    plain = _config(2, "fp32")
    offload = _config(2, "fp32", zero_optimization={"stage": 2, "cpu_offload": True})
    for save_cfg, load_cfg in ((plain, offload), (offload, plain)):
        a = _engine(save_cfg)
        _train(a, K, 0)
        a.save_checkpoint(str(tmp_path / "x"), tag=str(id(save_cfg)))
        b = _engine(load_cfg, seed=99)
        b.load_checkpoint(str(tmp_path / "x"), tag=str(id(save_cfg)))
        _assert_equal(_masters(b), _masters(a))
        want, got = _train(a, 1, K), _train(b, 1, K)
        np.testing.assert_allclose(got, want, rtol=1e-6)
        _close(a, b)


@pytest.mark.parametrize("stage,dtype", [(0, "bf16"), (1, "fp16"), (3, "bf16")])
def test_save_before_any_step(tmp_path, stage, dtype):
    a = _engine(_config(stage, dtype))
    assert a.save_checkpoint(str(tmp_path / "ckpt"))
    b = _engine(_config(stage, dtype), seed=99)
    b.load_checkpoint(str(tmp_path / "ckpt"))
    _assert_equal(_masters(b), _masters(a))
    assert _train(b, 2, 0) == _train(a, 2, 0)


def test_latest_tag(tmp_path):
    save_dir = str(tmp_path / "ckpt")
    engine = _engine(_config())
    _train(engine, 2, 0)
    engine.save_checkpoint(save_dir, tag="tag_a")
    _train(engine, 2, 2)
    engine.save_checkpoint(save_dir, tag="tag_b")
    with open(os.path.join(save_dir, "latest")) as f:
        assert f.read().strip() == "tag_b"
    name, _ = _engine(_config(), seed=42).load_checkpoint(save_dir)
    assert "tag_b" in name
    name, _ = _engine(_config(), seed=42).load_checkpoint(save_dir, tag="tag_a")
    assert "tag_a" in name


def test_client_state_round_trips(tmp_path):
    """``weights_only`` loading takes ints, floats, strings, the builtin
    containers and tensors."""
    save_dir = str(tmp_path / "ckpt")
    engine = _engine(_config())
    _train(engine, 2, 0)
    client = {"epoch": 7, "note": "hello", "loss": 2.5, "nested": {"a": [1, (2, "x")]},
              "t": torch.arange(3)}
    engine.save_checkpoint(save_dir, client_state=client)
    _, got = _engine(_config(), seed=42).load_checkpoint(save_dir)
    assert set(got) == set(client)
    assert got["epoch"] == 7 and got["note"] == "hello" and got["loss"] == 2.5
    assert got["nested"] == {"a": [1, (2, "x")]} and torch.equal(got["t"], torch.arange(3))


def test_lr_scheduler_and_step_state(tmp_path):
    save_dir = str(tmp_path / "ckpt")
    engine = _engine(_config())
    _train(engine, 4, 0)
    it = engine.lr_scheduler.last_batch_iteration
    engine.save_checkpoint(save_dir)
    engine2 = _engine(_config(), seed=42)
    engine2.load_checkpoint(save_dir)
    assert engine2.lr_scheduler.last_batch_iteration == it
    assert engine2.optimizer_state_dict()["step"] == 4
    assert torch.equal(engine2._step_gen.get_state(), engine._step_gen.get_state())


def test_load_without_optimizer_or_schedule_states(tmp_path):
    save_dir = str(tmp_path / "ckpt")
    engine = _engine(_config(2))
    _train(engine, 2, 0)
    engine.save_checkpoint(save_dir)
    fresh = _engine(_config(2), seed=99)
    fresh.load_checkpoint(save_dir, load_optimizer_states=False,
                          load_lr_scheduler_states=False)
    _assert_equal(_masters(fresh), _masters(engine))
    assert fresh.optimizer.inner_state.step == 0
    assert fresh.lr_scheduler.last_batch_iteration == 0


def test_missing_dir(tmp_path):
    name, client = _engine(_config()).load_checkpoint(str(tmp_path / "nope"))
    assert name is None and client == {}


def test_shard_files(tmp_path):
    """One shard a dp rank (one at world 1), unpadded, with the JAX
    package's keys."""
    save_dir = str(tmp_path / "ckpt")
    engine = _engine(_config(2, "fp16"))
    _train(engine, 2, 0)
    engine.save_checkpoint(save_dir, tag="z")
    files = sorted(os.listdir(os.path.join(save_dir, "z")))
    assert files == [MANIFEST_NAME, "mp_rank_00_model_states.pt",
                     "zero_pp_rank_0_mp_rank_00optim_states.pt"]
    shard = torch.load(os.path.join(save_dir, "z", files[2]), weights_only=True)
    assert {"rank", "dp_world_size", "numel", "master_from_params", "cpu_offload"} <= \
        set(shard)
    assert (shard["rank"], shard["dp_world_size"]) == (0, 1)
    assert shard["flat_master"].numel() == shard["numel"] == engine.optimizer._numel
    states = torch.load(os.path.join(save_dir, "z", files[1]), weights_only=True)
    assert list(states["module"]) == list(engine.master_params())
    assert all(v.dtype == torch.float32 for v in states["module"].values())


def test_initialize_accepts_the_sections_and_refuses_resilience():
    cfg = _config(checkpoint={"tag_validation": "Fail", "keep_last_k": 2,
                              "max_retries": 1, "retry_backoff_s": 0.0,
                              "verify_on_load": False},
                  telemetry={"enabled": False})
    engine = _engine(cfg)
    storage = engine.checkpoint_storage
    assert (storage.keep_last_k, storage.max_retries, storage.verify_on_load) == (2, 1, False)
    assert engine._config.checkpoint_tag_validation_fail
    with pytest.raises(ValueError, match="tag_validation"):
        _engine(_config(checkpoint={"tag_validation": "sometimes"}))
    with pytest.raises(ValueError, match="keep_last_k"):
        _engine(_config(checkpoint={"keep_last_k": -1}))
    # the resilience block is ported since slice 5b (the pipeline section
    # since slice 8a); a section that is not yet is still refused by name
    assert _engine(_config(resilience={"enabled": True})).resilience is not None
    with pytest.raises(NotImplementedError, match="curriculum_learning"):
        _engine(_config(curriculum_learning={"enabled": True}))


# ---------------------------------------------------------------------------
# fault injection: the atomic commit protocol survives a crash at every
# write stage, torn and corrupted files, and a deleted `latest`
# ---------------------------------------------------------------------------

def _cfg_ft(**ckpt):
    ckpt.setdefault("retry_backoff_s", 0)
    ckpt.setdefault("fault_injection", {})
    return _config(checkpoint=ckpt)


def _save_good_tag(tmp_path, cfg, tag="one"):
    save_dir = str(tmp_path / "ckpt")
    engine = _engine(cfg)
    _train(engine, 2, 0)
    engine.save_checkpoint(save_dir, tag=tag)
    return engine, save_dir, _masters(engine), engine.global_steps


def _module_states_file(save_dir, tag):
    manifest = read_manifest(os.path.join(save_dir, tag))
    (name,) = [n for n in manifest["files"] if "model_states" in n]
    return os.path.join(save_dir, tag, name)


@pytest.mark.faults
@pytest.mark.parametrize("point", ["tmp_write", "fsync", "rename", "manifest_write",
                                   "manifest_rename"])
def test_crash_at_every_write_stage_falls_back(tmp_path, point):
    cfg = _cfg_ft()
    engine, save_dir, masters_one, steps_one = _save_good_tag(tmp_path, cfg)
    _train(engine, 2, 2)
    engine.checkpoint_storage.fault_injector.arm(point, mode="crash")
    with pytest.raises(InjectedCrash):
        engine.save_checkpoint(save_dir, tag="two")
    engine.checkpoint_storage.fault_injector.disarm()
    assert read_manifest(os.path.join(save_dir, "two")) is None

    engine2 = _engine(cfg, seed=99)
    name, _ = engine2.load_checkpoint(save_dir)
    assert name is not None and "one" in name
    assert engine2.global_steps == steps_one
    _assert_equal(_masters(engine2), masters_one)


@pytest.mark.faults
def test_torn_tmp_write_falls_back(tmp_path):
    cfg = _cfg_ft()
    engine, save_dir, masters_one, _ = _save_good_tag(tmp_path, cfg)
    _train(engine, 2, 2)
    engine.checkpoint_storage.fault_injector.arm("tmp_write", after_bytes=16)
    with pytest.raises(InjectedCrash):
        engine.save_checkpoint(save_dir, tag="two")
    engine.checkpoint_storage.fault_injector.disarm()
    engine2 = _engine(cfg, seed=99)
    name, _ = engine2.load_checkpoint(save_dir)
    assert "one" in name
    _assert_equal(_masters(engine2), masters_one)


@pytest.mark.faults
def test_transient_eio_is_retried(tmp_path):
    cfg = _cfg_ft(max_retries=3)
    engine, save_dir, _, _ = _save_good_tag(tmp_path, cfg)
    fi = engine.checkpoint_storage.fault_injector
    fi.arm("tmp_write", mode="transient", times=2)
    _train(engine, 2, 2)
    engine.save_checkpoint(save_dir, tag="two")
    assert fi.fired["tmp_write"] == 2

    engine2 = _engine(cfg, seed=99)
    fi2 = engine2.checkpoint_storage.fault_injector
    fi2.arm("read", mode="transient", times=1)
    name, _ = engine2.load_checkpoint(save_dir)
    assert "two" in name
    assert fi2.fired["read"] == 1
    _assert_equal(_masters(engine2), _masters(engine))


@pytest.mark.faults
@pytest.mark.parametrize("damage", ["truncate", "flip_bit"])
def test_damaged_file_falls_back(tmp_path, damage):
    """A truncated file fails the size check, a flipped bit the read-time
    crc32 / sha256 check: fall back to the previous committed tag."""
    cfg = _cfg_ft()
    engine, save_dir, masters_one, steps_one = _save_good_tag(tmp_path, cfg)
    _train(engine, 2, 2)
    engine.save_checkpoint(save_dir, tag="two")
    path = _module_states_file(save_dir, "two")
    blob = bytearray(open(path, "rb").read())
    if damage == "truncate":
        blob = blob[:len(blob) // 2]
    else:
        blob[len(blob) // 2] ^= 0xFF
    with open(path, "wb") as f:
        f.write(bytes(blob))
    engine2 = _engine(cfg, seed=99)
    name, _ = engine2.load_checkpoint(save_dir)
    assert "one" in name
    assert engine2.global_steps == steps_one
    _assert_equal(_masters(engine2), masters_one)


@pytest.mark.faults
def test_deleted_latest_loads_newest_committed(tmp_path):
    cfg = _cfg_ft()
    engine, save_dir, _, _ = _save_good_tag(tmp_path, cfg)
    _train(engine, 2, 2)
    engine.save_checkpoint(save_dir, tag="two")
    os.remove(os.path.join(save_dir, "latest"))
    engine2 = _engine(cfg, seed=99)
    name, _ = engine2.load_checkpoint(save_dir)
    assert "two" in name
    _assert_equal(_masters(engine2), _masters(engine))
    manifest = read_manifest(os.path.join(save_dir, "two"))
    assert manifest["format_version"] == 1 and manifest["sequence"] == 2
    assert manifest["extra"] == {"global_steps": 4, "dp_world_size": 1, "mp_world_size": 1}
    for entry in manifest["files"].values():
        assert entry["bytes"] > 0 and entry["crc32"] and entry["sha256"]


@pytest.mark.faults
def test_crash_between_commit_and_latest(tmp_path):
    cfg = _cfg_ft()
    engine, save_dir, _, _ = _save_good_tag(tmp_path, cfg)
    _train(engine, 2, 2)
    engine.checkpoint_storage.fault_injector.arm("latest_write", mode="crash")
    with pytest.raises(InjectedCrash):
        engine.save_checkpoint(save_dir, tag="two")
    engine.checkpoint_storage.fault_injector.disarm()
    assert open(os.path.join(save_dir, "latest")).read().strip() == "one"
    engine2 = _engine(cfg, seed=99)
    name, _ = engine2.load_checkpoint(save_dir)
    assert "two" in name
    _assert_equal(_masters(engine2), _masters(engine))


@pytest.mark.faults
def test_all_candidates_corrupt_raises_named_error(tmp_path):
    cfg = _cfg_ft()
    _, save_dir, _, _ = _save_good_tag(tmp_path, cfg)
    with open(_module_states_file(save_dir, "one"), "wb") as f:
        f.write(b"not a pickle")
    with pytest.raises(CheckpointCorruptionError):
        _engine(cfg, seed=99).load_checkpoint(save_dir)


@pytest.mark.faults
def test_unpickling_error_without_manifest_is_named(tmp_path):
    """With no manifest to check, a garbage file reaches the unpickler,
    whose error becomes the named one."""
    cfg = _cfg_ft()
    _, save_dir, _, _ = _save_good_tag(tmp_path, cfg)
    os.remove(os.path.join(save_dir, "one", MANIFEST_NAME))
    with open(os.path.join(save_dir, "one", "mp_rank_00_model_states.pt"), "wb") as f:
        f.write(b"garbage")
    with pytest.raises(CheckpointCorruptionError, match="does not unpickle"):
        _engine(cfg, seed=99).load_checkpoint(save_dir)


@pytest.mark.faults
def test_rotation_keeps_newest_committed(tmp_path):
    cfg = _cfg_ft(keep_last_k=2)
    save_dir = str(tmp_path / "ckpt")
    engine = _engine(cfg)
    snapshots = {}
    for i in range(1, 6):
        _train(engine, 1, i)
        engine.save_checkpoint(save_dir, tag=f"t{i}")
        snapshots[f"t{i}"] = (_masters(engine), engine.global_steps)
    tag_dirs = sorted(d for d in os.listdir(save_dir)
                      if os.path.isdir(os.path.join(save_dir, d)))
    assert tag_dirs == ["t4", "t5"]
    with open(_module_states_file(save_dir, "t5"), "wb") as f:
        f.write(b"garbage")
    engine2 = _engine(cfg, seed=99)
    name, _ = engine2.load_checkpoint(save_dir)
    assert "t4" in name
    masters_t4, steps_t4 = snapshots["t4"]
    assert engine2.global_steps == steps_t4
    _assert_equal(_masters(engine2), masters_t4)


@pytest.mark.faults
def test_rotation_spares_uncommitted_dirs(tmp_path):
    cfg = _cfg_ft(keep_last_k=1)
    engine, save_dir, _, _ = _save_good_tag(tmp_path, cfg, tag="good")
    engine.checkpoint_storage.fault_injector.arm("manifest_rename", mode="crash")
    with pytest.raises(InjectedCrash):
        engine.save_checkpoint(save_dir, tag="crashed")
    engine.checkpoint_storage.fault_injector.disarm()
    _train(engine, 1, 2)
    engine.save_checkpoint(save_dir, tag="good2")
    dirs = {d for d in os.listdir(save_dir) if os.path.isdir(os.path.join(save_dir, d))}
    assert "good" not in dirs and "crashed" in dirs and "good2" in dirs


@pytest.mark.faults
def test_legacy_tag_without_manifest_loads(tmp_path):
    cfg = _cfg_ft()
    _, save_dir, masters_one, steps_one = _save_good_tag(tmp_path, cfg)
    os.remove(os.path.join(save_dir, "one", MANIFEST_NAME))
    engine2 = _engine(cfg, seed=99)
    name, _ = engine2.load_checkpoint(save_dir)
    assert "one" in name
    assert engine2.global_steps == steps_one
    _assert_equal(_masters(engine2), masters_one)


@pytest.mark.faults
def test_env_fault_spec_arms_the_engine(tmp_path, monkeypatch):
    """``DS_TPU_CKPT_FAULTS`` (the JAX package's variable) arms an
    unmodified training script's saves."""
    monkeypatch.setenv("DS_TPU_CKPT_FAULTS", "manifest_write:crash")
    engine = _engine(_config())
    with pytest.raises(InjectedCrash):
        engine.save_checkpoint(str(tmp_path / "ckpt"), tag="x")
    assert read_manifest(str(tmp_path / "ckpt" / "x")) is None


# ---------------------------------------------------------------------------
# tag watch (manifest level, no engine)
# ---------------------------------------------------------------------------

def _commit_plain_tag(root, tag, payload=b"w", pkg=None):
    storage = (pkg or CheckpointStorage)()
    w = storage.tag_writer(str(root), tag)
    w.write_file("weights.bin", payload)
    return w.commit()


def test_latest_committed_tag_orders_by_sequence(tmp_path):
    root = str(tmp_path / "ckpt")
    assert latest_committed_tag(root) is None
    _commit_plain_tag(root, "zz-first")
    _commit_plain_tag(root, "aa-second")
    assert latest_committed_tag(root) == ("aa-second", 2)


def test_latest_committed_tag_ignores_torn_and_uncommitted(tmp_path):
    root = str(tmp_path / "ckpt")
    _commit_plain_tag(root, "good")
    os.makedirs(os.path.join(root, "torn"))
    with open(os.path.join(root, "torn", "weights.bin"), "wb") as f:
        f.write(b"partial")
    os.makedirs(os.path.join(root, "half"))
    with open(os.path.join(root, "half", MANIFEST_NAME), "w") as f:
        f.write('{"version": 1, "seq')
    with open(os.path.join(root, "latest"), "w") as f:
        f.write("half")
    assert latest_committed_tag(root) == ("good", 1)


def test_tag_watcher_reports_each_change_once(tmp_path):
    root = str(tmp_path / "ckpt")
    w = TagWatcher(root)
    assert w.current() is None and w.poll() is None
    _commit_plain_tag(root, "a")
    assert w.poll() == ("a", 1)
    assert w.poll() is None
    _commit_plain_tag(root, "b")
    _commit_plain_tag(root, "c")
    assert w.poll() == ("c", 3)
    assert w.poll() is None


def test_tag_watcher_reports_rollback_to_previous_tag(tmp_path):
    root = str(tmp_path / "ckpt")
    _commit_plain_tag(root, "a")
    _commit_plain_tag(root, "b")
    w = TagWatcher(root)
    assert w.poll() is None
    os.remove(os.path.join(root, "b", MANIFEST_NAME))
    assert w.poll() == ("a", 1)
    assert w.poll() is None
    os.remove(os.path.join(root, "a", MANIFEST_NAME))
    assert w.current() is None


# ---------------------------------------------------------------------------
# the copied modules against the JAX package's, on the same inputs
# ---------------------------------------------------------------------------

def test_storage_and_manifest_match_jax(tmp_path):
    """Commits, manifests, load order and rotation of the two copies over
    the same files are the same, byte for byte."""
    trees = {}
    for label, storage_cls in (("jax", jckpt.CheckpointStorage), ("torch", CheckpointStorage)):
        root = tmp_path / label
        manifests = [_commit_plain_tag(root, t, payload=t.encode() * 100, pkg=storage_cls)
                     for t in ("b", "a", "c")]
        os.makedirs(root / "uncommitted")
        storage = storage_cls(keep_last_k=2)
        storage.write_latest(str(root), "a")
        trees[label] = dict(
            manifests=manifests,
            files=json.loads((root / "c" / MANIFEST_NAME).read_text()),
            candidates=storage.load_candidates(str(root)),
            explicit=storage.load_candidates(str(root), tag="uncommitted"),
            removed=storage.rotate(str(root)),
            latest=storage.read_latest_hint(str(root)),
            committed=storage.committed_tags(str(root)))
    assert trees["torch"] == trees["jax"]
    assert trees["torch"]["removed"] == ["b"]
    for data in (b"", b"abc", bytes(range(256)) * 5):
        assert jckpt.manifest.digests_of_bytes(data) == tmanifest.digests_of_bytes(data)


@pytest.mark.parametrize("spec", [
    "rename:crash;tmp_write:crash:after_bytes=10", "read:transient:times=3",
    "fsync:crash", ""])
def test_fault_spec_parses_as_jax(spec, monkeypatch):
    monkeypatch.setenv("DS_TPU_CKPT_FAULTS", spec)
    got, want = FaultInjector.from_env(), jckpt.FaultInjector.from_env()
    if not spec:
        assert got is None and want is None
        return
    arms = lambda fi: {p: (a.mode, a.times, a.after_bytes) for p, a in fi._arms.items()}
    assert arms(got) == arms(want)
