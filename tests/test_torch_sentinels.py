"""The port's program and transfer sentinels, after the JAX package's
``tests/unit/test_sentinels.py``, on the CPU.

``CompileSentinel`` budgets a function decorated with
``records_programs``: a program is one distinct call signature (tensor
shapes, dtypes and devices; the values of the other arguments; shape and
dtype alone for the arguments JAX would trace). ``transfer_free()`` arms
``torch.cuda.set_sync_debug_mode`` on a card; here, where there is no
card, its depth count and its restore are held with the mode's two
functions stood in for, and the allowlist with the JAX package's errors.
One serving scenario runs on both packages, and each port sentinel's
program count must equal the JAX sentinel's for the same program class.
"""

import threading

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

import deepspeed_tpu_torch as dt  # noqa: E402
from deepspeed_tpu.inference.serving.engine import ServingEngine as JServingEngine  # noqa: E402
from deepspeed_tpu.inference.serving.config import ServingConfig as JServingConfig  # noqa: E402
from deepspeed_tpu.models.gpt2 import GPT2Config as JGPT2Config, init_gpt2 as jinit  # noqa: E402
from deepspeed_tpu.profiling import sentinels as jsent  # noqa: E402
from deepspeed_tpu.profiling.config import DeepSpeedSentinelConfig as JSentinelConfig  # noqa: E402
from deepspeed_tpu_torch import telemetry  # noqa: E402
from deepspeed_tpu_torch.inference.generation import generate  # noqa: E402
from deepspeed_tpu_torch.inference.serving.config import ServingConfig  # noqa: E402
from deepspeed_tpu_torch.inference.serving.engine import ServingEngine  # noqa: E402
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, init_gpt2  # noqa: E402
from deepspeed_tpu_torch.profiling import (  # noqa: E402
    CompileBudgetExceededError,
    CompileSentinel,
    allowed_transfer,
    allowed_transfer_names,
    compile_cache_size,
    register_allowed_transfer,
    transfer_free,
)
from deepspeed_tpu_torch.profiling import sentinels  # noqa: E402
from deepspeed_tpu_torch.profiling.config import DeepSpeedSentinelConfig  # noqa: E402


def _fresh():
    @sentinels.records_programs
    def double(x):
        return x * 2

    return double


# -- CompileSentinel -----------------------------------------------------------

def test_warm_cache_never_charges_budget():
    fn = _fresh()
    fn(torch.ones(4))                     # recorded BEFORE the sentinel
    sentinel = CompileSentinel(fn, budget=0)
    for _ in range(3):
        sentinel(torch.ones(4))           # warm: zero new programs
    assert sentinel.compiles == 0
    assert sentinel.check() == 0


def test_budget_exceeded_raises_with_context():
    sentinel = CompileSentinel(_fresh(), budget=1, name="double")
    sentinel(torch.ones(4))
    with pytest.raises(CompileBudgetExceededError) as exc:
        sentinel(torch.ones(8))           # new shape: second program
    assert exc.value.name == "double"
    assert exc.value.compiles == 2 and exc.value.budget == 1
    assert "budget is 1" in str(exc.value)


def test_check_is_lazy_and_reset_forgives():
    fn = _fresh()
    sentinel = CompileSentinel(fn, budget=1)
    fn(torch.ones(4))                     # direct calls never raise...
    fn(torch.ones(8))
    fn(torch.ones(16, dtype=torch.float64))
    with pytest.raises(CompileBudgetExceededError):
        sentinel.check()                  # ...the assert at the end does
    sentinel.reset()
    assert sentinel.check() == 0
    sentinel.reset(budget=2)
    assert sentinel.budget == 2


def test_sentinel_is_transparent_proxy():
    fn = _fresh()
    sentinel = CompileSentinel(fn, budget=4)
    y = sentinel(torch.arange(3.0))
    torch.testing.assert_close(y, torch.tensor([0.0, 2.0, 4.0]))
    assert sentinel._cache_size() == compile_cache_size(fn)
    assert sentinel.__wrapped__.__name__ == "double"
    assert "budget=4" in repr(sentinel)


def test_sentinel_rejects_non_recorded_and_bad_budget():
    with pytest.raises(TypeError):
        CompileSentinel(lambda x: x, budget=1)
    with pytest.raises(TypeError):
        compile_cache_size(len)
    with pytest.raises(ValueError):
        CompileSentinel(_fresh(), budget=-1)
    with pytest.raises(ValueError):
        CompileSentinel(_fresh(), budget=3).reset(budget=-2)


def test_programs_key_on_signatures_traced_args_and_split_views():
    @sentinels.records_programs(split="impl", traced=("starts",))
    def step(x, starts, impl="dense", n_heads=4):
        return x

    step(torch.ones(2, 3), [0, 0])
    step(torch.ones(2, 3), [5, 1])                      # traced: same program
    step(torch.ones(2, 3), np.asarray([0, 0]))          # same shape and dtype
    step(torch.ones(2, 3), [0, 0], "dense", 8)          # a static value: new
    step(torch.ones(2, 3, dtype=torch.bfloat16), [0, 0], "window")
    step(torch.ones(2, 4), [0, 0, 0], impl="window")
    assert compile_cache_size(step) == 4
    assert compile_cache_size(step.view("dense")) == 2
    assert compile_cache_size(step.view("window")) == 2
    assert compile_cache_size(step.view("dense", "window")) == 4


def test_generate_records_its_programs():
    cfg = GPT2Config(vocab_size=31, hidden_size=16, num_hidden_layers=1,
                     num_attention_heads=2, max_position_embeddings=24,
                     hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    model = init_gpt2(cfg, seed=0, device="cpu")
    sentinel = CompileSentinel(generate, budget=1, name="generate")
    sentinel(model, cfg, [[1, 2, 3]], 2, device="cpu")
    sentinel(model, cfg, [[4, 5, 6]], 2, device="cpu")     # another prompt, same shape
    assert sentinel.compiles == 1
    with pytest.raises(CompileBudgetExceededError):
        sentinel(model, cfg, [[4, 5, 6, 7]], 2, device="cpu")


def test_recompiles_total_counted():
    telemetry.configure(True)
    counter = telemetry.get_registry().counter("Jax/recompiles_total")
    before = counter.value
    fn = _fresh()
    sentinel = CompileSentinel(fn, budget=8)
    for n in (2, 3, 3, 4):
        sentinel(torch.ones(n))
    assert counter.value - before == 3
    sentinel.check()                       # nothing new: nothing counted
    assert counter.value - before == 3


# -- the allowlist and transfer_free --------------------------------------------

def test_allowlist_errors_match_jax():
    for bad in ("", None, 3):
        with pytest.raises(ValueError) as got:
            register_allowed_transfer(bad)
        with pytest.raises(ValueError) as want:
            jsent.register_allowed_transfer(bad)
        assert str(got.value) == str(want.value)
    with pytest.raises(KeyError) as got:
        with allowed_transfer("test/never_registered"):
            pass
    assert "is not on the allowlist" in str(got.value)
    assert register_allowed_transfer("test/site") == "test/site"
    assert "test/site" in allowed_transfer_names()
    # ZeRO-Offload's two windows register at import, as in the JAX package
    assert {"zero/offload_d2h", "zero/offload_h2d"} <= allowed_transfer_names()


def test_windows_nest_per_thread():
    """Windows nest on any thread and leave the mode alone; the sanctioned
    transfers inside them are counted by name over the process."""
    register_allowed_transfer("test/outer")
    register_allowed_transfer("test/inner")
    sentinels.reset_transfer_counts()
    x = torch.ones(3)
    with allowed_transfer("test/outer"):
        with allowed_transfer("test/inner"):
            sentinels.device_get(x, "test/inner")
            t = threading.Thread(target=lambda: sentinels.device_put(x, "cpu", "test/outer"))
            t.start()
            t.join()
        sentinels.device_get(x, "test/inner")
    assert sentinels.transfer_counts() == {"test/inner": 2, "test/outer": 1}
    sentinels.reset_transfer_counts()
    assert sentinels.transfer_counts() == {}


@pytest.fixture
def fake_sync_mode(monkeypatch):
    """The sync-debug mode's functions stood in for, as on a card."""
    state = {"mode": 0, "sets": []}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: state["mode"])

    def set_mode(mode):
        state["sets"].append(mode)
        state["mode"] = mode
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", set_mode)
    return state


def test_transfer_free_arms_nests_across_threads_and_restores(fake_sync_mode):
    entered, leave = threading.Event(), threading.Event()

    def worker():
        with transfer_free():
            entered.set()
            leave.wait(5)

    with transfer_free():
        assert fake_sync_mode["mode"] == "error" and sentinels._GUARD["depth"] == 1
        t = threading.Thread(target=worker)
        t.start()
        entered.wait(5)
    # the main thread left; the worker's region still holds the mode
    assert fake_sync_mode["mode"] == "error"
    leave.set()
    t.join()
    assert fake_sync_mode["mode"] == 0 and sentinels._GUARD["depth"] == 0
    assert fake_sync_mode["sets"] == ["error", 0]


def test_transfer_free_restores_on_exception(fake_sync_mode):
    fake_sync_mode["mode"] = "warn"
    with pytest.raises(RuntimeError, match="planted"):
        with transfer_free():
            raise RuntimeError("planted")
    assert fake_sync_mode["mode"] == "warn"
    with pytest.raises(ValueError):
        with transfer_free("disallow_everything"):
            pass


def test_device_get_and_put_on_the_cpu():
    register_allowed_transfer("test/io")
    x = torch.arange(6).reshape(2, 3)
    torch.testing.assert_close(sentinels.device_get(x, "test/io"), x)
    assert sentinels.device_get(7, "test/io") == 7
    up = sentinels.device_put([[1, 2], [3, 4]], "cpu", "test/io", dtype=torch.long)
    assert up.dtype == torch.long and up.tolist() == [[1, 2], [3, 4]]
    with pytest.raises(KeyError):
        sentinels.device_get(x, "test/unknown_site")


# -- the jax_sentinels config block ---------------------------------------------

def test_sentinel_config_defaults_and_block_equal_jax():
    for block in ({}, {"jax_sentinels": {"enabled": True, "compile_budget": 2,
                                         "transfer_guard": True}}):
        assert vars(DeepSpeedSentinelConfig(block)) == vars(JSentinelConfig(block))
    assert vars(DeepSpeedSentinelConfig({})) == {"enabled": False, "compile_budget": 4,
                                                  "transfer_guard": False}


@pytest.mark.parametrize("budget", [0, -3, 1.5, True, "4", "four"])
def test_sentinel_config_rejects_bad_budget(budget):
    block = {"jax_sentinels": {"compile_budget": budget}}
    with pytest.raises(ValueError) as want:
        JSentinelConfig(block)
    with pytest.raises(ValueError) as got:
        DeepSpeedSentinelConfig(block)
    assert str(got.value) == str(want.value)


def test_sentinel_config_rejects_non_dict_block():
    for block in ("yes", True, [1]):
        with pytest.raises(ValueError):
            JSentinelConfig({"jax_sentinels": block})
        with pytest.raises(ValueError):
            DeepSpeedSentinelConfig({"jax_sentinels": block})


def test_ds_config_arms_the_sentinels_from_jax_sentinels():
    """The repaired key: ``jax_sentinels`` arms the sentinels (it was
    accepted and ignored), and a ``sentinel`` block, which no JAX code
    reads, is ignored as the JAX config ignores it (it was refused)."""
    from deepspeed_tpu.runtime.config import DeepSpeedConfig as JConfig
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig

    cfg = {"train_batch_size": 8, "jax_sentinels": {"enabled": True, "compile_budget": 7}}
    got = DeepSpeedConfig(dict(cfg), world_size=1).sentinel_config
    want = JConfig(dict(cfg), world_size=1).sentinel_config
    assert vars(got) == vars(want)
    assert got.enabled and got.compile_budget == 7 and not got.transfer_guard
    cfg = {"train_batch_size": 8, "sentinel": {"enabled": True}}
    assert not DeepSpeedConfig(dict(cfg), world_size=1).sentinel_config.enabled
    with pytest.raises(ValueError):
        DeepSpeedConfig({"train_batch_size": 8, "jax_sentinels": {"compile_budget": 0}},
                        world_size=1)


# -- the training engine --------------------------------------------------------

class _Linear(torch.nn.Module):
    def __init__(self):
        super().__init__()
        torch.manual_seed(0)
        self.lin = torch.nn.Linear(3, 1)

    def forward(self, x):
        return (self.lin(x) ** 2).mean()


def _train_engine(**sent):
    cfg = {"train_batch_size": 2, "optimizer": {"type": "Adam", "params": {"lr": 1e-2}},
           "jax_sentinels": {"enabled": True, **sent}}
    return dt.initialize(model=_Linear(), config=cfg, device="cpu")[0]


def test_train_step_budget_and_guard():
    engine = _train_engine(compile_budget=1, transfer_guard=True)
    x = torch.ones(2, 3)
    for _ in range(3):
        engine.train_step([(x,)])                # one signature: one program
    assert engine._train_step_sentinel.compiles == 1
    assert compile_cache_size(engine._train_step_programs) == 1
    with pytest.raises(CompileBudgetExceededError, match="fused train_step"):
        engine.train_step([(torch.ones(4, 3),)])   # runs, then the check raises
    plain = dt.initialize(model=_Linear(), config={
        "train_batch_size": 2, "optimizer": {"type": "Adam", "params": {"lr": 1e-2}}},
        device="cpu")[0]
    for xb in (x, x, x, torch.ones(4, 3)):
        plain.train_step([(xb,)])
    for a, b in zip(plain.master_params().values(), engine.master_params().values()):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="wall_clock_breakdown"):
        dt.initialize(model=_Linear(), device="cpu", config={
            "train_batch_size": 2, "wall_clock_breakdown": True,
            "optimizer": {"type": "Adam", "params": {"lr": 1e-2}},
            "jax_sentinels": {"enabled": True, "transfer_guard": True}})


def test_guarded_train_step_makes_no_host_read():
    engine = _train_engine(transfer_guard=True)
    x = torch.ones(2, 3)
    engine.train_step([(x,)])
    sentinels.reset_transfer_counts()
    engine.train_step([(x,)])
    assert sentinels.transfer_counts() == {}


def test_guarded_decode_step_makes_one_host_read():
    cfg = GPT2Config(**_CFG)
    eng = ServingEngine(init_gpt2(cfg, seed=0, device="cpu"), cfg,
                        ServingConfig(max_slots=4, max_seq_len=48, prompt_buckets=(4, 8, 16)),
                        device="cpu", sentinel_config=DeepSpeedSentinelConfig(
                            {"jax_sentinels": {"enabled": True, "transfer_guard": True}}))
    for n in (3, 7):
        eng.submit(list(range(1, n + 1)), max_new_tokens=8)
    for _ in range(4):                     # admit and prefill both, then decode
        stats = eng.step()
    assert stats["decoded"] == 2 and not stats["admitted"] and not stats["prefill_chunks"]
    sentinels.reset_transfer_counts()
    stats = eng.step()
    assert stats["decoded"] == 2 and not stats["admitted"]
    assert sentinels.transfer_counts() == {"serving/step_read": 1}
    eng.drain(max_steps=50)


# -- one serving scenario on both packages ---------------------------------------

_CFG = dict(vocab_size=61, hidden_size=24, num_hidden_layers=2, num_attention_heads=3,
            max_position_embeddings=48, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)
_LENS = (3, 7, 12, 5, 16, 2, 9, 4, 14, 6)
_NEW = (5, 3, 6, 2, 4, 7, 3, 5, 2, 4)
_CLASSES = ("decode_sentinel", "decode_window_sentinel", "decode_kernel_sentinel")
_PREFILLS = {"dense": "prefill_sentinel", "sparse_xla": "prefill_window_sentinel"}


def _drive(eng):
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, 50, n).tolist() for n in _LENS]
    futs = [eng.submit(p, max_new_tokens=m) for p, m in zip(prompts[:5], _NEW[:5])]
    eng.step()
    eng.step()
    futs += [eng.submit(p, max_new_tokens=m) for p, m in zip(prompts[5:], _NEW[5:])]
    eng.drain(max_steps=400)
    return [f.result(timeout=1) for f in futs]


@pytest.mark.parametrize("serving,vocab", [
    ({"attention_impl": {"default": "dense", 16: "sparse_xla"}, "kv_page_tokens": 8}, 61),
    ({"speculative_k": 2}, 59),
], ids=["dense_and_window", "speculative"])
def test_serving_program_counts_equal_jax(serving, vocab):
    """Each scenario has a model of its own (its vocabulary), so both
    packages start with no program of it recorded or compiled."""
    kw = dict(max_slots=4, max_queue=16, max_seq_len=48, prompt_buckets=(4, 8, 16), **serving)
    block = {"jax_sentinels": {"enabled": True, "compile_budget": 16, "transfer_guard": True}}
    cfg = dict(_CFG, vocab_size=vocab)
    jcfg = JGPT2Config(**cfg)
    _, params = jinit(jcfg, batch_size=1, seq_len=8, seed=0)
    jeng = JServingEngine(params, jcfg, JServingConfig(**kw),
                          sentinel_config=JSentinelConfig(block))
    tcfg = GPT2Config(**cfg)
    teng = ServingEngine(init_gpt2(tcfg, seed=0, device="cpu"), tcfg, ServingConfig(**kw),
                         device="cpu", sentinel_config=DeepSpeedSentinelConfig(block))
    assert teng._transfer_guard and jeng._transfer_guard
    jouts, touts = _drive(jeng), _drive(teng)
    assert [len(o) for o in jouts] == [len(o) for o in touts] == list(_NEW)
    counts = {}
    for name in _CLASSES:
        j, t = getattr(jeng, name), getattr(teng, name)
        assert (j is None) == (t is None), name
        if j is not None:
            counts[name] = t.compiles
            assert t.compiles == j.compiles, name
    for impl, name in _PREFILLS.items():
        j, t = getattr(jeng, name), teng.prefill_sentinels.get(impl)
        assert (j is None) == (t is None), name
        if j is not None:
            counts[name] = t.compiles
            assert t.compiles == j.compiles, name
    assert counts["decode_sentinel"] == 1 and counts["prefill_sentinel"] >= 2
    # a second identical pass adds no program
    _drive(teng)
    for name, n in counts.items():
        s = teng.prefill_sentinels[[k for k, v in _PREFILLS.items() if v == name][0]] \
            if name.startswith("prefill") else getattr(teng, name)
        assert s.compiles == n, name
