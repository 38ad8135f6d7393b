"""The port's job-level fault tolerance: the worker group's supervisor,
preemption, deadline-bounded control collectives, health gossip, and the
launch front ends.

Counterpart of ``tests/unit/test_cluster_resilience.py`` (its elastic
resume cases are in test_torch_elastic.py). The supervisor units run tiny
stdlib children. The end-to-end cases run real tiny-BERT training workers
(``_tiny_bert_config()``, sequence 128, dropout 0.1, bf16 Adam, on the
CPU) under ``WorkerSupervisor``: a worker SIGKILLed at step 2, and one
SIGTERMed at step 2 with no periodic checkpoints (only the preemption's
emergency checkpoint carries it across), each restart once and end with
fp32 masters equal to an uninterrupted run's, bit for bit. A group of two
stdlib workers shows the group rule: one dies, the other is stopped, both
restart. No tolerance anywhere. The world-2 case over gloo (two
processes through ``launch``) is marked slow.
"""

import os
import signal
import subprocess
import sys
import threading
import time

import pytest
import torch

from deepspeed_tpu_torch.comm import comm
from deepspeed_tpu_torch.comm.errors import CommError, CommTimeoutError, DeadPeerError
from deepspeed_tpu_torch.comm.health import HealthGossip
from deepspeed_tpu_torch.launcher import launch
from deepspeed_tpu_torch.launcher import multinode_runner as mnr
from deepspeed_tpu_torch.launcher.runner import decode_world_info, encode_world_info
from deepspeed_tpu_torch.launcher.supervisor import (
    CLASS_CLEAN,
    CLASS_CRASH,
    CLASS_FATAL,
    CLASS_HUNG,
    CLASS_PREEMPTED,
    EXIT_PREEMPTED,
    HEARTBEAT_FILE_ENV,
    PREEMPT_SAVE_DIR_ENV,
    TELEMETRY_PORT_ENV,
    WorkerSupervisor,
    classify_exit,
)
from deepspeed_tpu_torch.runtime.resilience import (
    ClusterFaultInjector,
    PreemptionHandler,
    set_active_injector,
)

pytestmark = pytest.mark.faults

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
TOTAL_STEPS = 4
FAULT_STEP = 2

# ---------------------------------------------------------------------------
# WorkerSupervisor units (tiny python -c children)
# ---------------------------------------------------------------------------

# crash (or preempt) once, then exit clean: the marker file records that the
# first incarnation already failed
_FLAKY_CHILD = (
    "import os, sys\n"
    "p = os.environ['FLAKY_MARKER']\n"
    "if os.path.exists(p):\n"
    "    sys.exit(0)\n"
    "open(p, 'w').close()\n"
    "sys.exit(int(os.environ.get('FLAKY_RC', '3')))\n"
)


def _child(code):
    return [sys.executable, "-c", code]


def test_classify_exit():
    assert classify_exit(0) == CLASS_CLEAN
    assert classify_exit(EXIT_PREEMPTED) == CLASS_PREEMPTED
    assert classify_exit(98) == CLASS_FATAL
    assert classify_exit(1) == CLASS_CRASH
    assert classify_exit(-9) == CLASS_CRASH
    assert classify_exit(98, fatal_exit_codes=()) == CLASS_CRASH


def test_supervisor_clean_exit_no_restart():
    sup = WorkerSupervisor(_child("pass"), max_restarts=5, backoff_s=0.01)
    assert sup.run() == 0
    assert sup.restarts == 0
    assert sup.exit_history == [(CLASS_CLEAN, 0)]


def test_supervisor_restarts_crash_until_success(tmp_path):
    env = dict(os.environ, FLAKY_MARKER=str(tmp_path / "crashed"), FLAKY_RC="3")
    sup = WorkerSupervisor(_child(_FLAKY_CHILD), env=env, max_restarts=2, backoff_s=0.01)
    assert sup.run() == 0
    assert sup.restarts == 1
    assert sup.exit_history == [(CLASS_CRASH, 3), (CLASS_CLEAN, 0)]


def test_supervisor_fatal_exit_never_restarts():
    sup = WorkerSupervisor(_child("import sys; sys.exit(98)"), max_restarts=5, backoff_s=0.01)
    assert sup.run() == 98
    assert sup.restarts == 0
    assert sup.exit_history == [(CLASS_FATAL, 98)]


def test_supervisor_preempted_restarts_without_backoff(tmp_path):
    env = dict(os.environ, FLAKY_MARKER=str(tmp_path / "preempted"),
               FLAKY_RC=str(EXIT_PREEMPTED))
    sup = WorkerSupervisor(_child(_FLAKY_CHILD), env=env, max_restarts=1, backoff_s=5.0)
    t0 = time.monotonic()
    assert sup.run() == 0
    assert time.monotonic() - t0 < 4.0
    assert sup.exit_history == [(CLASS_PREEMPTED, EXIT_PREEMPTED), (CLASS_CLEAN, 0)]


def test_supervisor_budget_exhausted_propagates_rc():
    sup = WorkerSupervisor(_child("import sys; sys.exit(3)"), max_restarts=1, backoff_s=0.01)
    assert sup.run() == 3
    assert sup.restarts == 1
    assert sup.exit_history == [(CLASS_CRASH, 3), (CLASS_CRASH, 3)]


def test_supervisor_kills_worker_with_stale_heartbeat(tmp_path):
    hb = tmp_path / "hb"
    hb.touch()
    sup = WorkerSupervisor(_child("import time; time.sleep(60)"),
                           heartbeat_timeout_s=0.5, heartbeat_file=str(hb),
                           term_grace_s=1.0, max_restarts=0)
    t0 = time.monotonic()
    rc = sup.run()
    assert time.monotonic() - t0 < 10.0
    assert rc != 0
    assert sup.exit_history[0][0] == CLASS_HUNG


def test_supervisor_beating_worker_stays_alive():
    code = (
        "import os, time\n"
        "p = os.environ[%r]\n"
        "for _ in range(12):\n"
        "    os.utime(p, None)\n"
        "    time.sleep(0.1)\n"
    ) % HEARTBEAT_FILE_ENV
    sup = WorkerSupervisor(_child(code), heartbeat_timeout_s=0.5, max_restarts=0)
    assert sup.run() == 0
    assert sup.exit_history == [(CLASS_CLEAN, 0)]


# ---------------------------------------------------------------------------
# a group of local workers
# ---------------------------------------------------------------------------

# local rank 1 dies (exit 3) in its first incarnation, once local rank 0
# has started; local rank 0 would wait forever for it, as a rank blocked in
# a collective with a dead peer does; in the second incarnation both
# finish. Each counts its own
# incarnations and records its heartbeat file and local rank.
_GROUP_CHILD = (
    "import os, sys, time\n"
    "lr = os.environ['LOCAL_RANK']\n"
    "runs = os.path.join(os.environ['GROUP_DIR'], 'runs_' + lr)\n"
    "first = not os.path.exists(runs)\n"
    "with open(os.path.join(os.environ['GROUP_DIR'], 'seen'), 'a') as f:\n"
    "    f.write(lr + ' ' + os.environ['%s'] + '\\n')\n"
    "open(runs, 'a').close()\n"
    "if first and lr == '1':\n"
    "    while not os.path.exists(os.path.join(os.environ['GROUP_DIR'], 'runs_0')):\n"
    "        time.sleep(0.01)\n"
    "    sys.exit(3)\n"
    "if first:\n"
    "    time.sleep(60)\n"
) % HEARTBEAT_FILE_ENV


def test_group_one_worker_dies_the_group_restarts(tmp_path):
    env = dict(os.environ, GROUP_DIR=str(tmp_path))
    sup = WorkerSupervisor(_child(_GROUP_CHILD), env=env,
                           local_envs=[{"LOCAL_RANK": "0"}, {"LOCAL_RANK": "1"}],
                           heartbeat_timeout_s=30.0, heartbeat_file=str(tmp_path / "hb"),
                           max_restarts=2, backoff_s=0.01, term_grace_s=2.0)
    t0 = time.monotonic()
    assert sup.run() == 0
    assert time.monotonic() - t0 < 20.0       # rank 0 was stopped, not waited out
    assert sup.restarts == 1
    assert sup.exit_history == [(CLASS_CRASH, 3), (CLASS_CLEAN, 0)]
    # the survivor was stopped by the supervisor (SIGTERM), not counted
    assert sup.member_history[0] == [("stopped", -signal.SIGTERM), (CLASS_CRASH, 3)]
    assert sup.member_history[1] == [(CLASS_CLEAN, 0), (CLASS_CLEAN, 0)]
    seen = sorted((tmp_path / "seen").read_text().split("\n")[:-1])
    hb = str(tmp_path / "hb")
    assert seen == [f"0 {hb}.0", f"0 {hb}.0", f"1 {hb}.1", f"1 {hb}.1"]


def test_group_exit_class_is_its_worst_member(tmp_path):
    # one worker clean, one poisoned: the group is fatal and never restarts.
    # The poisoned one exits only once the clean one has ended (its process
    # a zombie or gone), so that both end on their own and both are counted.
    code = (
        "import os, sys, time\n"
        "pid_file = os.path.join(os.environ['GROUP_DIR'], 'pid0')\n"
        "if os.environ['LOCAL_RANK'] == '0':\n"
        "    with open(pid_file + '.tmp', 'w') as f:\n"
        "        f.write(str(os.getpid()))\n"
        "    os.replace(pid_file + '.tmp', pid_file)\n"
        "    sys.exit(0)\n"
        "while not os.path.exists(pid_file):\n"
        "    time.sleep(0.01)\n"
        "pid = open(pid_file).read()\n"
        "def ended():\n"
        "    try:\n"
        "        return open(f'/proc/{pid}/stat').read().rsplit(')', 1)[1].split()[0] in 'ZX'\n"
        "    except OSError:\n"
        "        return True\n"
        "while not ended():\n"
        "    time.sleep(0.01)\n"
        "sys.exit(98)\n"
    )
    env = dict(os.environ, GROUP_DIR=str(tmp_path))
    sup = WorkerSupervisor(_child(code), env=env,
                           local_envs=[{"LOCAL_RANK": "0"}, {"LOCAL_RANK": "1"}],
                           max_restarts=3, backoff_s=0.01)
    assert sup.run() == 98
    assert sup.exit_history == [(CLASS_FATAL, 98)]
    assert sorted(sup.member_history[0]) == [(CLASS_CLEAN, 0), (CLASS_FATAL, 98)]


def test_group_signal_is_forwarded_to_every_worker(tmp_path):
    """SIGTERM to the supervisor reaches every worker; each commits (here:
    exits 99) and the supervisor returns the group's code, no restart."""
    code = (
        "import os, signal, sys, time\n"
        "signal.signal(signal.SIGTERM, lambda *a: sys.exit(99))\n"
        "open(os.path.join(os.environ['GROUP_DIR'], os.environ['LOCAL_RANK']), 'w').close()\n"
        "time.sleep(60)\n"
    )
    env = dict(os.environ, GROUP_DIR=str(tmp_path))
    sup = WorkerSupervisor(_child(code), env=env, max_restarts=3,
                           local_envs=[{"LOCAL_RANK": "0"}, {"LOCAL_RANK": "1"}])

    def preempt():
        deadline = time.monotonic() + 20
        while not all((tmp_path / r).exists() for r in "01") and time.monotonic() < deadline:
            time.sleep(0.02)
        os.kill(os.getpid(), signal.SIGTERM)

    threading.Thread(target=preempt, daemon=True).start()
    assert sup.run() == EXIT_PREEMPTED
    assert sup.restarts == 0 and sup.exit_history == []
    assert sup.member_history[0] == [(CLASS_PREEMPTED, 99), (CLASS_PREEMPTED, 99)]


_TELEMETRY_CHILD = """\
import os, sys, time
sys.path.insert(0, os.environ["DSTORCH_REPO"])
from deepspeed_tpu_torch import telemetry

# the engine's own binding: no http_port in the block, so the launcher's port
srv = telemetry.TelemetryServer(port=telemetry.resolve_http_port(None)).start()
d = os.environ["GROUP_DIR"]
with open(os.path.join(d, "tmp" + os.environ["LOCAL_RANK"]), "w") as f:
    f.write(str(srv.port))
os.replace(os.path.join(d, "tmp" + os.environ["LOCAL_RANK"]),
           os.path.join(d, "port" + os.environ["LOCAL_RANK"]))
deadline = time.monotonic() + 60      # both endpoints are up at once
while not all(os.path.exists(os.path.join(d, f"port{r}")) for r in "01"):
    if time.monotonic() > deadline:
        sys.exit(4)
    time.sleep(0.01)
srv.stop()
"""


def _free_port_pair():
    import socket

    for _ in range(50):
        with socket.socket() as a:
            a.bind(("127.0.0.1", 0))
            port = a.getsockname()[1]
            try:
                with socket.socket() as b:
                    b.bind(("127.0.0.1", port + 1))
            except OSError:
                continue
        return port
    raise RuntimeError("no two consecutive free ports")


def test_group_workers_get_their_own_telemetry_port(tmp_path):
    """``launch --worker_telemetry_port P`` with two local workers: worker
    i binds P + i, so both workers' engines serve their endpoints at once
    (one shared port would fail the second bind and crash the group)."""
    sup = WorkerSupervisor(_child(""), local_envs=[{}, {}], worker_port=7000)
    assert [sup.worker_env(i)[TELEMETRY_PORT_ENV] for i in range(2)] == ["7000", "7001"]
    assert sup.worker_endpoints == ["http://127.0.0.1:7000", "http://127.0.0.1:7001"]
    assert WorkerSupervisor(_child("")).worker_endpoints is None

    script = tmp_path / "telemetry_worker.py"
    script.write_text(_TELEMETRY_CHILD)
    env = dict(os.environ, DSTORCH_REPO=REPO, GROUP_DIR=str(tmp_path))
    env.pop(TELEMETRY_PORT_ENV, None)
    port = _free_port_pair()
    world = encode_world_info({"localhost": [0, 1]})
    proc = subprocess.run([sys.executable, "-m", "deepspeed_tpu_torch.launcher.launch",
                           f"--world_info={world}", f"--worker_telemetry_port={port}",
                           str(script)],
                          env=env, capture_output=True, text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert [(tmp_path / f"port{r}").read_text() for r in "01"] == [str(port), str(port + 1)]


# ---------------------------------------------------------------------------
# supervised end to end: kill / preempt a real tiny-BERT worker, resume,
# equal an uninterrupted run bit for bit
# ---------------------------------------------------------------------------

WORKER_SCRIPT = """\
import dataclasses, os, sys
sys.path.insert(0, os.environ["DSTORCH_REPO"])
import torch
import deepspeed_tpu_torch as dt
from __graft_entry__ import _bert_batch, _tiny_bert_config

torch.set_num_threads(int(os.environ.get("WORKER_THREADS", "1")))
# one exp before any threaded one: see the world-2 ZeRO-2 test's docstring
torch.exp(torch.zeros(16))
ck = os.environ["WORKER_CKPT"]
total = int(os.environ["WORKER_STEPS"])
fault = os.environ.get("WORKER_FAULT", "")
save_every = os.environ.get("WORKER_SAVE_EVERY", "1") == "1"

res = {"max_recoveries": 2, "recovery_backoff_s": 0}
if fault:
    point = {"kill": "kill_worker", "preempt": "preempt_signal"}[fault]
    res["fault_injection"] = {point: {"at_step": int(os.environ["WORKER_FAULT_STEP"]),
                                      "marker": os.environ["WORKER_MARKER"]}}
cfg = {"train_batch_size": 4 * int(os.environ.get("WORLD_SIZE", "1")), "steps_per_print": 1000,
       "bf16": {"enabled": True}, "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
       "zero_optimization": {"stage": int(os.environ.get("WORKER_ZERO", "0"))},
       "resilience": res}
d = dataclasses.asdict(_tiny_bert_config())
d.pop("scan_unroll")
d.update(max_position_embeddings=128, hidden_dropout_prob=0.1,
         attention_probs_dropout_prob=0.1)
model = dt.init_bert(dt.BertConfig(**d), seed=0, device="cpu")
eng, _, _, _ = dt.initialize(model=model, config=cfg, device="cpu")
eng.load_checkpoint(ck)  # nothing there yet -> (None, {}): start from step 0

def batch(i):
    # batches keyed on the step: a resumed run trains on the clean data
    return tuple(torch.from_numpy(x) for x in _bert_batch(4, 128, 256, 1000 + i))

while eng.global_steps < total:
    eng.train_batch(iter([batch(eng.global_steps)]))
    if save_every:
        eng.save_checkpoint(ck)

masters = eng.master_params()
if eng.global_rank == 0:
    torch.save(masters, os.environ["WORKER_OUT"])
print("WORKER_DONE", eng.global_steps, flush=True)
"""


def _worker_env(tmp, **extra):
    env = dict(os.environ)
    env.update({
        "DSTORCH_REPO": REPO,
        "WORKER_CKPT": str(tmp / "ckpt"),
        "WORKER_OUT": str(tmp / "final.pt"),
        "WORKER_STEPS": str(TOTAL_STEPS),
    })
    for k in (HEARTBEAT_FILE_ENV, PREEMPT_SAVE_DIR_ENV, "DSTPU_PREEMPTION",
              "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        env.pop(k, None)
    env.update({k: str(v) for k, v in extra.items()})
    return env


def _write_worker(tmp):
    script = tmp / "worker.py"
    script.write_text(WORKER_SCRIPT)
    return str(script)


def _final_masters(path):
    return torch.load(path, weights_only=True)


def _equal(got, want):
    return got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want)


@pytest.fixture(scope="module")
def clean_final(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("clean")
    proc = subprocess.run([sys.executable, "-u", _write_worker(tmp)], env=_worker_env(tmp),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert f"WORKER_DONE {TOTAL_STEPS}" in proc.stdout
    return _final_masters(tmp / "final.pt")


def test_killed_worker_resumes_to_bitwise_match(tmp_path, clean_final):
    env = _worker_env(tmp_path, WORKER_FAULT="kill", WORKER_FAULT_STEP=FAULT_STEP,
                      WORKER_MARKER=tmp_path / "killed")
    sup = WorkerSupervisor([sys.executable, "-u", _write_worker(tmp_path)],
                           env=env, max_restarts=2, backoff_s=0.01)
    assert sup.run() == 0
    assert sup.restarts == 1
    assert sup.exit_history == [(CLASS_CRASH, -signal.SIGKILL), (CLASS_CLEAN, 0)]
    assert _equal(_final_masters(tmp_path / "final.pt"), clean_final)


def test_preempted_worker_commits_emergency_checkpoint_and_resumes(tmp_path, clean_final):
    ck = tmp_path / "ckpt"
    env = _worker_env(tmp_path, WORKER_FAULT="preempt", WORKER_FAULT_STEP=FAULT_STEP,
                      WORKER_MARKER=tmp_path / "preempted", WORKER_SAVE_EVERY="0",
                      **{PREEMPT_SAVE_DIR_ENV: ck})
    sup = WorkerSupervisor([sys.executable, "-u", _write_worker(tmp_path)],
                           env=env, max_restarts=2, backoff_s=5.0)
    t0 = time.monotonic()
    assert sup.run() == 0
    assert sup.exit_history == [(CLASS_PREEMPTED, EXIT_PREEMPTED), (CLASS_CLEAN, 0)]
    assert sup.restarts == 1
    assert (ck / f"global_step{FAULT_STEP}").is_dir()
    assert _equal(_final_masters(tmp_path / "final.pt"), clean_final)
    assert time.monotonic() - t0 < 280


def _tiny_engine(tmp_path, **resilience):
    import dataclasses

    import deepspeed_tpu_torch as dt
    from __graft_entry__ import _tiny_bert_config

    d = dataclasses.asdict(_tiny_bert_config())
    d.pop("scan_unroll")
    cfg = {"train_batch_size": 4, "steps_per_print": 1000,
           "optimizer": {"type": "Adam", "params": {"lr": 1e-3}}}
    if resilience:
        cfg["resilience"] = dict({"max_recoveries": 2, "recovery_backoff_s": 0}, **resilience)
    model = dt.init_bert(dt.BertConfig(**d), seed=0, device="cpu")
    return dt.initialize(model=model, config=cfg, device="cpu")[0]


def test_preemption_handler_in_process(tmp_path):
    """Signal -> flag -> emergency checkpoint at the step boundary ->
    SystemExit(EXIT_PREEMPTED), without a subprocess in the loop."""
    eng = _tiny_engine(tmp_path)
    handler = PreemptionHandler(eng, save_dir=str(tmp_path / "emerg")).install()
    try:
        assert not handler.requested
        handler.check()
        os.kill(os.getpid(), signal.SIGTERM)
        deadline = time.monotonic() + 5
        while not handler.requested and time.monotonic() < deadline:
            time.sleep(0.01)
        assert handler.requested
        with pytest.raises(SystemExit) as ei:
            handler.check()
        assert ei.value.code == EXIT_PREEMPTED
        assert (tmp_path / "emerg" / handler.emergency_tag).is_dir()
    finally:
        handler.uninstall()


def test_preemption_keeps_a_step_already_committed(tmp_path):
    """A signal at the boundary right after a save of the same step exits
    99 without saving the step again: the committed tag's manifest and
    files stay as they were (a rank whose peer died could not finish a
    new save, and starting one uncommits the tag)."""
    eng = _tiny_engine(tmp_path)
    ck = tmp_path / "ck"
    eng.save_checkpoint(str(ck))
    manifest = (ck / "global_step0" / "manifest.json").read_bytes()
    stamps = {p.name: p.stat().st_mtime_ns for p in (ck / "global_step0").iterdir()}
    handler = PreemptionHandler(eng, save_dir=str(ck))
    handler._requested.set()
    handler._received = signal.SIGTERM
    with pytest.raises(SystemExit) as ei:
        handler.check()
    assert ei.value.code == EXIT_PREEMPTED and handler.emergency_tag == "global_step0"
    assert (ck / "global_step0" / "manifest.json").read_bytes() == manifest
    assert {p.name: p.stat().st_mtime_ns for p in (ck / "global_step0").iterdir()} == stamps


# ---------------------------------------------------------------------------
# comm deadlines (the hang_barrier arm drives the CommTimeoutError path)
# ---------------------------------------------------------------------------

def test_barrier_timeout_raises_within_deadline():
    ClusterFaultInjector({"hang_barrier": {"seconds": 30.0, "times": 2}})
    try:
        t0 = time.monotonic()
        with pytest.raises(CommTimeoutError):
            comm.barrier("wedged", timeout_s=0.3)
        assert time.monotonic() - t0 < 5.0
        with pytest.raises(CommTimeoutError):
            comm.host_allreduce_scalar(1.0, timeout_s=0.3)
    finally:
        set_active_injector(None)


def test_barrier_with_deadline_still_completes_unwedged():
    assert comm.barrier("healthy", timeout_s=30.0) is None
    assert comm.host_allreduce_scalar(2.5, timeout_s=30.0) == 2.5


def test_comm_timeout_bounds_checkpoint_commit_barrier(tmp_path):
    """``resilience.comm_timeout_s`` bounds the engine's commit barrier; the
    tag (committed before the barrier) survives, and with no process group
    the next commit goes through."""
    eng = _tiny_engine(tmp_path, comm_timeout_s=0.3,
                       fault_injection={"hang_barrier": {"seconds": 30.0}})
    try:
        t0 = time.monotonic()
        with pytest.raises(CommTimeoutError):
            eng.save_checkpoint(str(tmp_path / "ck"))
        assert time.monotonic() - t0 < 5.0
        assert (tmp_path / "ck" / "global_step0" / "manifest.json").exists()
        assert eng.save_checkpoint(str(tmp_path / "ck"))
    finally:
        set_active_injector(None)


def test_group_refuses_control_calls_after_a_timeout(tmp_path):
    """With a process group (world 1 over gloo, a FileStore), the control
    collectives run on it; once a deadline has passed the process refuses
    every later control call by name, since its groups cannot be trusted."""
    store = torch.distributed.FileStore(str(tmp_path / "store"), 1)
    torch.distributed.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        assert comm.barrier("healthy", timeout_s=30.0) is None
        assert comm.control_group() is torch.distributed.group.WORLD
        assert comm.host_allreduce_scalar(1.5, timeout_s=30.0) == 1.5
        ClusterFaultInjector({"hang_barrier": {"seconds": 1.0, "times": 1}})
        with pytest.raises(CommTimeoutError):
            comm.barrier("wedged", timeout_s=0.3)
        with pytest.raises(CommError, match="refused"):
            comm.barrier("after", timeout_s=30.0)
        with pytest.raises(CommError, match="refused"):
            comm.host_allreduce_scalar(1.0)
    finally:
        set_active_injector(None)
        torch.distributed.destroy_process_group()
        comm.forget_timeout()


def test_comm_timeout_error_taxonomy():
    e = CommTimeoutError(what="barrier 'x'", timeout_s=1.5)
    assert isinstance(e, TimeoutError) and isinstance(e, CommError)
    assert "barrier 'x'" in str(e) and "1.5" in str(e)
    d = DeadPeerError(rank=3, stale_s=7.0, timeout_s=2.0)
    assert isinstance(d, CommError)
    assert d.rank == 3 and "restart" in str(d)


# ---------------------------------------------------------------------------
# health gossip
# ---------------------------------------------------------------------------

def test_health_gossip_detects_dead_peer(tmp_path):
    a = HealthGossip(str(tmp_path), rank=0, world_size=2, peer_timeout_s=0.2)
    b = HealthGossip(str(tmp_path), rank=1, world_size=2, peer_timeout_s=0.2)
    a.check_peers()
    b.check_peers()
    time.sleep(0.35)
    a.beat()
    with pytest.raises(DeadPeerError) as ei:
        a.check_peers()
    assert ei.value.rank == 1
    assert ei.value.stale_s > 0.2
    b.beat()
    a.check_peers()


def test_health_gossip_startup_grace(tmp_path):
    g = HealthGossip(str(tmp_path), rank=0, world_size=4, peer_timeout_s=5.0)
    assert g.stale_peers() == []
    assert g.last_seen(2) < 1.0


def test_dead_peer_arm_suppresses_heartbeat(tmp_path, monkeypatch):
    hb = tmp_path / "hb"
    hb.touch()
    monkeypatch.setenv(HEARTBEAT_FILE_ENV, str(hb))
    monkeypatch.delenv("DSTPU_PREEMPTION", raising=False)
    import numpy as np

    from __graft_entry__ import _bert_batch

    eng = _tiny_engine(tmp_path, fault_injection={"dead_peer": {"at_step": 1}})
    try:
        for i in range(3):
            b = tuple(torch.from_numpy(np.asarray(x)) for x in _bert_batch(4, 64, 256, i))
            eng.train_batch(iter([b]))
        assert eng._cluster.heartbeat is not None
        assert eng._cluster.heartbeat.beats == 1   # step 0 beat; steps 1..2 silenced
        assert eng.resilience.injector.fired.get("dead_peer") == 1
    finally:
        set_active_injector(None)


# ---------------------------------------------------------------------------
# launch: node_rank validation, exit-code propagation, runner hygiene
# ---------------------------------------------------------------------------

def _mk_args(**over):
    import argparse

    ns = argparse.Namespace(launcher_args="", master_port=29500, user_script="train.py",
                            user_args=["--flag"], max_restarts=0, heartbeat_timeout_s=0.0)
    for k, v in over.items():
        setattr(ns, k, v)
    return ns


def test_launch_rejects_out_of_range_node_rank(monkeypatch):
    world = encode_world_info({"host-0": [0]})
    monkeypatch.setattr(sys, "argv", [
        "launch.py", f"--world_info={world}", "--node_rank=5", "train.py"])
    with pytest.raises(SystemExit) as ei:
        launch.main()
    assert ei.value.code == 2


def test_launch_propagates_child_exit_code(tmp_path, monkeypatch):
    script = tmp_path / "boom.py"
    script.write_text("import sys; sys.exit(7)\n")
    world = encode_world_info({"host-0": [0]})
    monkeypatch.setattr(sys, "argv", [
        "launch.py", f"--world_info={world}", "--node_rank=0", str(script)])
    with pytest.raises(SystemExit) as ei:
        launch.main()
    assert ei.value.code == 7


def test_launch_refuses_the_fleet_options_by_name(monkeypatch):
    """The fleet's options, once refused by name, are taken as the JAX
    launcher takes them: each local worker gets its own replica port and
    the replica config."""
    from deepspeed_tpu_torch.launcher.supervisor import (
        REPLICA_CONFIG_ENV,
        REPLICA_PORT_ENV,
        WorkerSupervisor,
    )

    world = encode_world_info({"host-0": [0, 1]})
    args = launch.parse_args([f"--world_info={world}", "--replica_port=7000",
                              "--replica_config=r.json", "--collector_port=0", "train.py"])
    assert (args.replica_port, args.replica_config, args.collector_port) == (7000, "r.json", 0)
    envs = launch.worker_envs(decode_world_info(world), 0, "127.0.0.1", 29500)
    sup = WorkerSupervisor(["true"], env={}, local_envs=envs, replica_port=args.replica_port,
                           replica_config=args.replica_config)
    assert [sup.worker_env(i)[REPLICA_PORT_ENV] for i in range(2)] == ["7000", "7001"]
    assert {sup.worker_env(i)[REPLICA_CONFIG_ENV] for i in range(2)} == {"r.json"}
    assert sup.replica_endpoints == [("127.0.0.1", 7000), ("127.0.0.1", 7001)]
    # the training script's own arguments are not the launcher's
    args = launch.parse_args([f"--world_info={world}", "train.py", "--replica_port=1"])
    assert args.training_script_args == ["--replica_port=1"] and args.replica_port is None


def test_ssh_runner_propagates_first_nonzero_status(tmp_path):
    fake_bin = tmp_path / "bin"
    fake_bin.mkdir()
    ssh = fake_bin / "ssh"
    ssh.write_text('#!/bin/sh\ncase "$1" in\n  failhost) exit 7 ;;\nesac\nexit 0\n')
    ssh.chmod(0o755)
    env = dict(os.environ, PATH=f"{fake_bin}:{os.environ['PATH']}")

    world = encode_world_info({"okhost": [0], "failhost": [0]})
    cmd = mnr.SSHRunner(_mk_args(), world, "10.0.0.1").get_cmd()
    assert "deepspeed_tpu_torch.launcher.launch" in cmd[-1]
    assert subprocess.run(cmd, env=env, capture_output=True).returncode == 7

    world_ok = encode_world_info({"okhost": [0], "otherhost": [0]})
    cmd = mnr.SSHRunner(_mk_args(), world_ok, "10.0.0.1").get_cmd()
    assert subprocess.run(cmd, env=env, capture_output=True).returncode == 0


def test_mvapich_runner_cleans_up_hostfile():
    world = encode_world_info({"worker-0": [0], "worker-1": [0]})
    r = mnr.MVAPICHRunner(_mk_args(max_restarts=2), world, "10.0.0.1", {})
    cmd = r.get_cmd()
    assert "deepspeed_tpu_torch.launcher.launch" in cmd and "--max_restarts=2" in cmd
    hostfile = cmd[cmd.index("-hostfile") + 1]
    assert os.path.exists(hostfile)
    r.cleanup()
    assert not os.path.exists(hostfile)
    r.cleanup()


# ---------------------------------------------------------------------------
# world 2 over gloo through launch (two processes)
# ---------------------------------------------------------------------------

_RANK_SCRIPT = """\
import os, sys, time
sys.path.insert(0, os.environ["DSTORCH_REPO"])
import torch
from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.utils import distributed as dist

dist.init_distributed(verbose=False, device_type="cpu")
rank = dist.get_rank()
comm.barrier("start", timeout_s=60)
total = comm.host_allreduce_scalar(float(rank + 1), timeout_s=60)
if rank == 1:
    time.sleep(8)         # rank 1 stays away: rank 0's next barrier has no peer
    os._exit(0)
try:
    comm.barrier("alone", timeout_s=2)
    sys.exit(5)
except comm.CommTimeoutError:
    pass
with open(os.environ["OUT"], "w") as f:
    f.write(f"{total} {os.environ['RANK']} {os.environ['WORLD_SIZE']} {os.environ['LOCAL_RANK']}")
os._exit(0)               # the abandoned barrier thread cannot be joined
"""


@pytest.mark.slow
def test_world_two_over_gloo_through_launch(tmp_path, monkeypatch):
    """launch starts two ranks on this host; they meet on the control
    group, sum a scalar, and rank 0's barrier without its peer raises
    CommTimeoutError within its deadline."""
    script = tmp_path / "rank.py"
    script.write_text(_RANK_SCRIPT)
    env = dict(os.environ, DSTORCH_REPO=REPO, OUT=str(tmp_path / "out"))
    env.pop("WORLD_SIZE", None)
    world = encode_world_info({"localhost": [0, 1]})
    port = 29000 + os.getpid() % 1000
    proc = subprocess.run([sys.executable, "-m", "deepspeed_tpu_torch.launcher.launch",
                           f"--world_info={world}", "--node_rank=0",
                           f"--master_port={port}", str(script)],
                          env=env, capture_output=True, text=True, timeout=240, cwd=REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert (tmp_path / "out").read_text() == "3.0 0 2 0"


@pytest.mark.slow
def test_group_of_two_ranks_killed_restarts_and_resumes_bit_for_bit(tmp_path):
    """Two tiny-BERT ranks at ZeRO-2 over gloo through ``launch``: one rank
    is SIGKILLed at step 2 (the marker lets one rank claim the arm), its
    peer is stopped by the supervisor, the group restarts once and both
    resume from the step-2 tag; the masters equal an uninterrupted
    two-rank run's bit for bit. Each rank runs two intra-op threads, and
    each worker makes one serial ``torch.exp`` before training: without
    it, in about one process in twenty, the first threaded ``exp`` of the
    process (the attention softmax's, 131072 elements, split between two
    OpenMP threads) gave bit-identical inputs an output whose second
    thread's half was off by up to 1.2e3 ulp, at ZeRO stage 0 as at
    stage 2, before any collective. Readings in ROADMAP.md, queue 3."""
    world = encode_world_info({"localhost": [0, 1]})
    script = _write_worker(tmp_path)

    def run(sub, **extra):
        d = tmp_path / sub
        d.mkdir()
        env = _worker_env(d, WORKER_ZERO=2, WORKER_THREADS=2, **extra)
        port = 29000 + (os.getpid() + len(sub)) % 1000
        proc = subprocess.run([sys.executable, "-m", "deepspeed_tpu_torch.launcher.launch",
                               f"--world_info={world}", f"--master_port={port}",
                               "--max_restarts=1", "--restart_backoff_s=0.1", script],
                              env=env, capture_output=True, text=True, timeout=600, cwd=REPO)
        assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
        return proc, _final_masters(d / "final.pt")

    _, clean = run("clean")
    proc, got = run("killed", WORKER_FAULT="kill", WORKER_FAULT_STEP=FAULT_STEP,
                    WORKER_MARKER=tmp_path / "fired")
    assert "restart 1/1" in proc.stderr + proc.stdout
    assert _equal(got, clean)
