"""The port's monitors against the JAX package's, on the CPU.

Mirrors ``tests/unit/test_monitor.py``: CRC32c against its known vectors,
the TFRecord framing, each event record's bytes equal to the JAX writer's
for the same tag, step, value and wall time, buffering until ``flush``
(a tensor is read only there), rank != 0 writing nothing, the CSV
monitor's rows. Then the engines: the ``DeepSpeedEngine``'s TensorBoard
and CSV scalars are the JAX engine's tags at the same steps on the same
model and config (values 1e-5 relative, fp32; the timer scalars by tag
and step only), on the three-call and the fused paths; the pipeline's
``Train/Samples/*`` and ``Train/Pipe/*`` records against the JAX
pipeline's; ``ServingMetrics`` and ``RolloutMetrics`` record JAX's
``(tag, value, step)`` stream, and ``ServingEngine.from_config`` writes
them on ``close()``.
"""

import glob
import os
import struct

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import deepspeed_tpu  # noqa: E402
import deepspeed_tpu_torch as dt  # noqa: E402
from deepspeed_tpu.inference.serving import metrics as jmetrics  # noqa: E402
from deepspeed_tpu.monitor import tensorboard as jtb  # noqa: E402
from deepspeed_tpu_torch.inference.serving import metrics as tmetrics  # noqa: E402
from deepspeed_tpu_torch.monitor import (  # noqa: E402
    CsvMonitor,
    MultiMonitor,
    SummaryWriter,
    TensorBoardMonitor,
    monitor_from_config,
    read_events,
)
from deepspeed_tpu_torch.monitor import tensorboard as ttb  # noqa: E402


def test_crc32c_known_vectors():
    # RFC 3720's vectors
    assert ttb._crc32c(b"") == 0x00000000
    assert ttb._crc32c(b"123456789") == 0xE3069283
    assert ttb._crc32c(bytes(32)) == 0x8A9136AA
    assert ttb._crc32c(bytes([0xFF] * 32)) == 0x62A8AB43


def test_tfrecord_framing_round_trips(tmp_path):
    payload = b"hello deepspeed"
    rec = ttb._tfrecord(payload)
    (length,) = struct.unpack("<Q", rec[:8])
    assert length == len(payload)
    assert struct.unpack("<I", rec[8:12])[0] == ttb._masked_crc(rec[:8])
    assert rec[12:12 + length] == payload
    assert struct.unpack("<I", rec[12 + length:])[0] == ttb._masked_crc(payload)
    path = tmp_path / "r.tfrecord"
    path.write_bytes(rec + ttb._tfrecord(b"") + ttb._tfrecord(b"x" * 300))
    assert ttb.read_records(str(path)) == [payload, b"", b"x" * 300]
    bad = bytearray(path.read_bytes())
    bad[14] ^= 1
    path.write_bytes(bytes(bad))
    with pytest.raises(ValueError, match="CRC"):
        ttb.read_records(str(path))


@pytest.mark.parametrize("tag,step,value,wall", [
    ("Train/Samples/train_loss", 8, 2.5, 1700000000.25),
    ("Train/Samples/lr", 0, 1e-4, 1.0),
    ("Serving/ttft_s", 123456789012, -3.75e-9, 1234.5),
    ("täg", 1, float("inf"), 0.0),
])
def test_event_record_bytes_equal_jax(tag, step, value, wall):
    assert ttb._event_scalar(wall, step, tag, value) == jtb._event_scalar(wall, step, tag, value)
    assert ttb._tfrecord(ttb._event_scalar(wall, step, tag, value)) == \
        jtb._tfrecord(jtb._event_scalar(wall, step, tag, value))
    assert ttb._event_file_version(wall) == jtb._event_file_version(wall)


def test_summary_writer_reads_back(tmp_path):
    w = SummaryWriter(str(tmp_path / "tb"))
    for step in range(5):
        w.add_scalar("Train/Samples/train_loss", 2.0 - 0.25 * step, step, walltime=10.0 + step)
    w.add_scalar("Train/Samples/lr", 0.5, 4, walltime=20.0)
    w.close()
    files = glob.glob(str(tmp_path / "tb" / "events.out.tfevents.*"))
    assert len(files) == 1
    got = read_events(files[0])
    assert got == [(10.0 + s, s, "Train/Samples/train_loss", 2.0 - 0.25 * s) for s in range(5)] \
        + [(20.0, 4, "Train/Samples/lr", 0.5)]
    # the JAX writer's file reads back the same through the port's parser
    jw = jtb.SummaryWriter(str(tmp_path / "jtb"))
    jw.add_scalar("x", 1.5, 3, walltime=5.0)
    jw.close()
    assert read_events(glob.glob(str(tmp_path / "jtb" / "events.*"))[0]) == [(5.0, 3, "x", 1.5)]


def test_monitor_buffers_until_flush(tmp_path):
    mon = TensorBoardMonitor(str(tmp_path / "out"), "job", rank=0)
    mon.record("x", torch.tensor(1.5), 0)       # a tensor: read only at the flush
    mon.record("x", 2.5, 1)
    path = mon.writer._path
    size = os.path.getsize(path)
    mon.flush()
    assert os.path.getsize(path) > size
    mon.close()
    assert [(s, t, v) for _, s, t, v in read_events(path)] == [(0, "x", 1.5), (1, "x", 2.5)]


def test_rank_nonzero_writes_nothing(tmp_path):
    for cls in (TensorBoardMonitor, CsvMonitor):
        mon = cls(str(tmp_path / "out"), "job", rank=1)
        mon.record("x", 1.0, 0)
        mon.flush()
        mon.close()
        assert not mon.enabled
    assert not os.path.exists(tmp_path / "out" / "job")


def test_csv_monitor_writes_buffers_and_truncates(tmp_path):
    out = str(tmp_path / "csv")
    m = CsvMonitor(out, "job", rank=0)
    m.record("Train/loss", 1.5, 8)
    m.record("Train/loss", torch.tensor(1.25), 16)
    m.record("Train/lr", 0.1, 8)
    path = os.path.join(out, "job", "Train_loss.csv")
    assert not os.path.exists(path)
    m.flush()
    lines = open(path).read().strip().splitlines()
    assert lines[0] == "step,value,walltime"
    assert lines[1].startswith("8,1.5,") and lines[2].startswith("16,1.25,")
    m.record("Train/loss", 1.0, 24)
    m.close()
    lines = open(path).read().strip().splitlines()
    assert len(lines) == 4 and lines[3].startswith("24,1.0,")
    m2 = CsvMonitor(out, "job", rank=0)
    m2.record("Train/loss", 9.0, 8)
    m2.flush()
    lines = open(path).read().strip().splitlines()
    assert len(lines) == 2 and lines[1].startswith("8,9.0,")
    m2.close()
    small = CsvMonitor(out, "auto", rank=0, auto_flush_every=2)
    small.record("a", 1.0, 1)
    small.record("a", 2.0, 2)
    assert os.path.exists(os.path.join(out, "auto", "a.csv"))
    small.close()


def test_monitor_from_config_matches_jax(tmp_path):
    from deepspeed_tpu.runtime.config import DeepSpeedConfig as JConfig

    for sections, kinds in (({}, None), ({"tensorboard": {"enabled": True}}, "TensorBoardMonitor"),
                            ({"csv_monitor": {"enabled": True}}, "CsvMonitor"),
                            ({"tensorboard": {"enabled": True}, "csv_monitor": {"enabled": True},
                              "telemetry": {"enabled": True}}, "MultiMonitor")):
        for sec in sections.values():
            if isinstance(sec, dict) and "enabled" in sec:
                sec["output_path"] = str(tmp_path / "m")
        cfg = {"train_batch_size": 1, **sections}
        got = monitor_from_config(dt.DeepSpeedConfig(dict(cfg), world_size=1), 0)
        want = deepspeed_tpu.monitor.monitor_from_config(JConfig(dict(cfg), world_size=1), 0)
        assert type(got).__name__ == type(want).__name__ == (kinds or "NoneType")
        if isinstance(got, MultiMonitor):
            assert [type(m).__name__ for m in got.monitors] == \
                [type(m).__name__ for m in want.monitors]
            got.close()
            want.close()
    from deepspeed_tpu_torch import telemetry
    telemetry.configure(False)


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------

class _Linear(torch.nn.Module):
    """``mean((x @ w - y)^2)`` with w = ones(4, 2): the JAX test's model."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.ones(4, 2))

    def forward(self, x, y):
        return ((x @ self.w - y) ** 2).mean()


def _monitor_cfg(out, **kw):
    cfg = {"train_batch_size": 8, "train_micro_batch_size_per_gpu": 8,
           "gradient_accumulation_steps": 1,
           "optimizer": {"type": "Adam", "params": {"lr": 1e-2}}, "steps_per_print": 2,
           "tensorboard": {"enabled": True, "output_path": out, "job_name": "unit"},
           "csv_monitor": {"enabled": True, "output_path": out, "job_name": "unit"}}
    cfg.update(kw)
    return cfg


def _scalars(out):
    """{tag: [(step, value)]} from the event file and from the CSVs."""
    tb = {}
    for path in glob.glob(os.path.join(out, "unit", "events.out.tfevents.*")):
        for _, step, tag, value in read_events(path):
            tb.setdefault(tag, []).append((step, value))
    csv = {}
    for path in glob.glob(os.path.join(out, "unit", "*.csv")):
        rows = open(path).read().strip().splitlines()[1:]
        csv[os.path.basename(path)[:-4]] = [(int(r.split(",")[0]), float(r.split(",")[1]))
                                            for r in rows]
    return tb, csv


def _same(got, want, timed=()):
    assert set(got) == set(want)
    for tag, rows in want.items():
        assert [s for s, _ in got[tag]] == [s for s, _ in rows], tag
        if not any(t in tag for t in timed):
            np.testing.assert_allclose([v for _, v in got[tag]], [v for _, v in rows],
                                       rtol=1e-5, err_msg=tag)


@pytest.mark.parametrize("path", ["three_call", "train_step", "three_call_breakdown"])
def test_engine_scalars_equal_the_jax_engine(tmp_path, path):
    rng = np.random.RandomState(0)
    x = rng.randn(8, 4).astype(np.float32)
    y = rng.randn(8, 2).astype(np.float32)
    extra = {"wall_clock_breakdown": True} if path.endswith("breakdown") else {}
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "torch")

    def jmodel(params, x, y):
        return jnp.mean((x @ params["w"] - y) ** 2)

    jeng, _, _, _ = deepspeed_tpu.initialize(
        model=jmodel, model_parameters={"w": jnp.ones((4, 2))},
        config_params=_monitor_cfg(jout, mesh={"data_parallel_size": 1}, **extra))
    teng, _, _, _ = dt.initialize(model=_Linear(), config=_monitor_cfg(tout, **extra),
                                  device="cpu")
    for _ in range(4):
        if path == "train_step":
            jeng.train_step([(jnp.asarray(x), jnp.asarray(y))])
            teng.train_step([(torch.from_numpy(x), torch.from_numpy(y))])
        else:
            for eng, xs in ((jeng, (jnp.asarray(x), jnp.asarray(y))),
                            (teng, (torch.from_numpy(x), torch.from_numpy(y)))):
                loss = eng(*xs)
                eng.backward(loss)
                eng.step()
    # steps_per_print 2: steps 1-4 were written at steps 2 and 4
    jtb_, jcsv = _scalars(jout)
    ttb_, tcsv = _scalars(tout)
    assert [s for s, _ in ttb_["Train/Samples/train_loss"]] == [8, 16, 24, 32]
    timed = ("microstep",)
    _same(ttb_, jtb_, timed)
    _same(tcsv, jcsv, timed)
    assert ("Train/Samples/forward_microstep" in ttb_) == bool(extra)
    teng.close()
    jeng.monitor.close()


def test_engine_flushes_at_close_and_at_save(tmp_path):
    out = str(tmp_path / "m")
    teng, _, _, _ = dt.initialize(model=_Linear(), config=_monitor_cfg(out, steps_per_print=100),
                                  device="cpu")
    x, y = torch.ones(8, 4), torch.zeros(8, 2)
    teng.train_step([(x, y)])
    assert "Train/Samples/train_loss" not in _scalars(out)[0]
    teng.save_checkpoint(str(tmp_path / "ck"))
    assert [s for s, _ in _scalars(out)[0]["Train/Samples/train_loss"]] == [8]
    teng.train_step([(x, y)])
    teng.close()
    assert [s for s, _ in _scalars(out)[1]["Train_Samples_train_loss"]] == [8, 16]


def test_wall_clock_breakdown_logs_the_microstep_timers(tmp_path):
    teng, _, _, _ = dt.initialize(
        model=_Linear(), config=_monitor_cfg(str(tmp_path), wall_clock_breakdown=True,
                                             memory_breakdown=True), device="cpu")
    assert teng.wall_clock_breakdown() and teng.memory_breakdown()
    line, log = [], teng.timers.log
    teng.timers.log = lambda *a, **kw: line.append(log(*a, **kw))
    for _ in range(3):
        teng.train_step([(torch.ones(8, 4), torch.zeros(8, 2))])
    assert len(line) == 1                     # at step 2 of 3
    for name in ("forward_microstep", "backward_microstep", "step_microstep", "MemAllocated"):
        assert name in line[0]
    names = ("forward_microstep", "backward_microstep", "step_microstep")
    assert all(teng.timers(n).elapsed_ > 0 for n in names)      # step 3 since the log
    teng.timers.log(names)
    assert all(teng.timers(n).elapsed_ == 0.0 for n in names)   # log() resets them
    teng.close()


def test_pipeline_records_equal_the_jax_pipeline(tmp_path):
    import test_torch_pipe as tp

    from deepspeed_tpu.runtime.pipe.module import PipelineModule as JaxPipelineModule
    from deepspeed_tpu_torch.runtime.pipe.module import PipelineModule

    def cfg(out):
        return tp._config({"tensorboard": {"enabled": True, "output_path": out,
                                           "job_name": "unit"},
                           "steps_per_print": 2})

    jm = JaxPipelineModule(tp._jax_layers(False), num_stages=2, loss_fn=tp._jax_mse,
                           partition_method="uniform")
    init = jm.init_params(jnp.zeros((tp.GLOBAL_MB, tp.HIDDEN), jnp.float32))
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "torch")
    jeng, _, _, _ = deepspeed_tpu.initialize(
        model=jm, config_params=dict(cfg(jout), mesh={"data_parallel_size": 1},
                                     pipeline={"executor": "interpreted"}))
    module = PipelineModule(tp._torch_layers(False), num_stages=2, loss_fn=tp.mse_loss,
                            partition_method="uniform")
    module.load_jax_params([None if p is None else jax.tree_util.tree_map(np.asarray, p)
                            for p in init])
    teng, _, _, _ = dt.initialize(model=module, config_params=cfg(tout), device="cpu")
    data = tp._data(4)
    jeng.train_batch(iter(data))
    jeng.train_batch(iter(data[2:]))
    teng.train_batch(iter(tp._torch_batches(data)))
    teng.train_batch(iter(tp._torch_batches(data[2:])))
    want, got = _scalars(jout)[0], _scalars(tout)[0]
    assert {"Train/Pipe/stage0_time_ms", "Train/Pipe/stage1_time_ms", "Train/Pipe/bubble_frac",
            "Train/Pipe/est_parallel_step_ms", "Train/Samples/train_loss",
            "Train/Samples/lr"} == set(got)
    _same(got, want, timed=("_ms",))
    assert all(v > 0 for _, v in got["Train/Pipe/stage0_time_ms"])
    teng.close()
    jeng.monitor.close()


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

class _Recorder:
    enabled = True

    def __init__(self):
        self.rows = []
        self.flushes = 0

    def record(self, tag, value, step):
        self.rows.append((tag, float(value), step))

    def flush(self):
        self.flushes += 1


def _drive_serving(m, jax_side):
    m.record_first_token(0.25)
    m.record_first_token(0.5)
    if jax_side:
        m.record_prefill(tokens=12, reused_tokens=4, requests=2, prefill_s=0.5)
    else:
        m.record_prefill(tokens=12, requests=2, prefill_s=0.5, reused_tokens=4)
    for hit in (True, False, True):
        m.record_prefix_lookup(hit)
        m.record_spill_lookup(not hit)
    m.record_spill_corrupt()
    m.record_admission(8, 5)
    m.record_admission(8, 7)
    m.record_step(queue_depth=1, active_slots=2, max_slots=4, tokens_this_step=6, step_s=0.1,
                  accepted_tokens=3, proposed_tokens=8, pages_in_use=5, page_fragmentation=0.25)
    m.record_step(queue_depth=0, active_slots=1, max_slots=4, tokens_this_step=1, step_s=0.0)
    for ev in ("export", "install", "dup_install", "resume", "reaped"):
        m.record_handoff(ev)
    m.record_kv_pool_bytes(4096)
    m.close()


def test_serving_and_rollout_metrics_record_the_jax_stream():
    got, want = _Recorder(), _Recorder()
    _drive_serving(tmetrics.ServingMetrics(got), False)
    _drive_serving(jmetrics.ServingMetrics(want), True)
    assert got.rows == want.rows and got.flushes == want.flushes == 1
    got, want = _Recorder(), _Recorder()
    for cls, rec in ((tmetrics.RolloutMetrics, got), (jmetrics.RolloutMetrics, want)):
        r = cls(rec)
        r.begin_rollout("v2")
        r.record_shadow(True)
        r.record_shadow(False)
        r.set_phase("canary")
        r.record_rollback("diverged")
    assert got.rows == want.rows and len(got.rows) == 5
    tmetrics.ServingMetrics().close()          # no monitor: nothing to do


def test_serving_engine_from_config_writes_its_records_on_close(tmp_path):
    cfg = dt.GPT2Config(vocab_size=64, hidden_size=64, num_hidden_layers=2,
                        num_attention_heads=4, max_position_embeddings=32,
                        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    model = dt.init_gpt2(cfg, seed=0, device="cpu")
    out = str(tmp_path / "serve")
    ds = {"train_batch_size": 1,
          "serving": {"max_slots": 2, "max_seq_len": 32, "prompt_buckets": [4, 8]},
          "tensorboard": {"enabled": True, "output_path": out, "job_name": "unit"}}
    eng = dt.ServingEngine.from_config(model, cfg, ds, device="cpu")
    fut = eng.submit([5, 9, 2], max_new_tokens=3)
    eng.drain(max_steps=50)
    assert len(fut.result()) > 0
    assert _scalars(out)[0] == {}           # buffered until close
    eng.close()
    tags = set(_scalars(out)[0])
    assert {"Serving/ttft_s", "Serving/prefill_batch", "Serving/tokens_per_step",
            "Serving/queue_depth", "Serving/kv_pool_bytes"} <= tags
