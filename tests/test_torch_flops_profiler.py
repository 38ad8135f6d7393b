"""The port's FLOPS profiler, held against the JAX package on the CPU.

The formatting helpers, the inclusive tree and the aggregated and
per-module report lines are fed the same scope -> FLOPs tables as the
JAX profiler and must print the same strings. A tiny BERT (2 layers,
hidden 64, 4 heads), weights carried over with ``from_jax_params``, is
counted under ``FlopCounterMode`` and held to the ``dot_general`` FLOPs
walked from ``jax.make_jaxpr`` of the same forward and forward plus
backward: the forwards equal exactly, and the backwards differ by one
named term each, the attention backward's recompute (see
``_recompute_term``). The kernels' FLOP formulas are held to the counter's
reading of their plain versions, and the engine's profiled run to an
unprofiled one, bit for bit.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

import deepspeed_tpu  # noqa: E402
import deepspeed_tpu_torch as dt  # noqa: E402
from __graft_entry__ import _bert_batch, _tiny_bert_config  # noqa: E402
from deepspeed_tpu.models.bert import BertForPreTraining as JBert  # noqa: E402
from deepspeed_tpu.profiling.config import DeepSpeedFlopsProfilerConfig as JProfCfg  # noqa: E402
from deepspeed_tpu.profiling.flops_profiler import profiler as jprof  # noqa: E402
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JConfig  # noqa: E402
from deepspeed_tpu_torch.kernels import decode_attention as tdecode  # noqa: E402
from deepspeed_tpu_torch.kernels import sparse_attention as tband  # noqa: E402
from deepspeed_tpu_torch.models.bert import BertConfig, BertForPreTraining  # noqa: E402
from deepspeed_tpu_torch.ops.transformer import attention as tattn  # noqa: E402
from deepspeed_tpu_torch.profiling.config import DeepSpeedFlopsProfilerConfig  # noqa: E402
from deepspeed_tpu_torch.profiling.flops_profiler import profiler as tprof  # noqa: E402
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig  # noqa: E402

_TO_NP = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
HEADS = 4


# -- the report ------------------------------------------------------------------

@pytest.mark.parametrize("value", [0, 7, 999, 1000, 123456, 9.87e8, 3.2e12, 4.5e15, 2e18])
def test_formatting_helpers_equal_jax(value):
    for name in ("flops_to_string", "macs_to_string", "params_to_string"):
        assert getattr(tprof, name)(value) == getattr(jprof, name)(value), name
    for seconds in (value / 1e9, value / 1e6, 2.5):
        assert tprof.duration_to_string(seconds) == jprof.duration_to_string(seconds)


_TABLE = {
    "Bert/embeddings": 0,
    "Bert/encoder/layers_0/qkv": 3 * 2 * 64 * 64 * 256,
    "Bert/encoder/layers_0/attn_out": 2 * 64 * 64 * 256,
    "Bert/encoder/layers_0": 2 * 2 * 32 * 32 * 16 * 8,
    "Bert/encoder/layers_1/qkv": 3 * 2 * 64 * 64 * 256,
    "Bert/encoder/layers_1/ff1": 2 * 64 * 128 * 256,
    "Bert/pooler": 2 * 64 * 64 * 2,
    "": 2 * 64 * 256 * 256,
}
_PARAMS = {"Bert/embeddings": 256 * 64, "Bert/encoder/layers_0/qkv": 3 * 64 * 64 + 192,
           "Bert/encoder/layers_1/ff1": 64 * 128 + 128, "Bert/pooler": 64 * 64 + 64}


@pytest.mark.parametrize("depth,top,detailed,params,duration", [
    (-1, 3, True, True, 0.0123), (1, 2, False, True, 0.0), (2, 5, True, False, 1.5),
    (0, 1, True, True, 0.0), (7, 3, False, False, 2e-4),
])
def test_report_lines_equal_jax(depth, top, detailed, params, duration):
    profs = []
    for mod in (tprof, jprof):
        p = mod.FlopsProfiler()
        p.module_flops = dict(_TABLE)
        p.module_params = dict(_PARAMS) if params else {}
        p.flops = sum(_TABLE.values())
        p.params = sum(_PARAMS.values())
        p.duration = duration
        profs.append(p)
    ours, theirs = profs
    assert ours._inclusive_tree() == theirs._inclusive_tree()
    inc_f, inc_p = ours._inclusive_tree()
    assert (ours._aggregated_lines(inc_f, inc_p, depth, top)
            == theirs._aggregated_lines(inc_f, inc_p, depth, top))
    kw = dict(profile_step=3, module_depth=depth, top_modules=top, detailed=detailed)
    assert ours.print_model_profile(**kw) == theirs.print_model_profile(**kw)


def test_flops_profiler_config_equals_jax():
    for block in ({}, {"flops_profiler": {"enabled": True, "profile_step": 3,
                                          "module_depth": 2, "top_modules": 5,
                                          "detailed": False}}):
        assert vars(DeepSpeedFlopsProfilerConfig(block)) == vars(JProfCfg(block))
        cfg = {"train_batch_size": 4, **block}
        got = DeepSpeedConfig(dict(cfg), world_size=1).flops_profiler_config
        assert vars(got) == vars(JConfig(dict(cfg), world_size=1).flops_profiler_config)


def test_device_peak_and_mfu():
    assert tprof.device_peak_tflops("NVIDIA H100 80GB HBM3") == 989.0
    assert tprof.device_peak_tflops("NVIDIA GeForce RTX 4090") is None
    assert tprof.device_peak_tflops() is None           # no card here
    p = tprof.FlopsProfiler()
    p.set_flops(989e12)
    p.duration = 2.0
    assert p.achieved_tflops() == pytest.approx(494.5)
    assert p.mfu("NVIDIA H100 80GB HBM3") == pytest.approx(0.5)
    assert p.mfu() is None


# -- the kernels' counts ----------------------------------------------------------

def _count(fn):
    with FlopCounterMode(display=False) as mode:
        fn()
    return mode.get_total_flops()


@pytest.mark.parametrize("causal,sparse", [(False, False), (True, False), (False, True)])
def test_flash_kernel_formulas_equal_the_plain_versions(causal, sparse):
    B, H, S, D, blk = 2, 3, 64, 16, 16
    g = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn(B, H, S, D, generator=g) for _ in range(4))
    bias = torch.zeros(B, S)
    layout = None
    if sparse:
        layout = (np.random.RandomState(0).rand(H, S // blk, S // blk) > 0.5).astype(np.int64)
        layout[:, :, 0] = 1
        layout[1, 2, :] = 0                  # a row with no block in one head
    lut, counts, qlut, qcounts = (torch.from_numpy(np.ascontiguousarray(t))
                                  for t in tattn._luts_for(layout, H, S, blk))
    kw = dict(block=blk, causal=causal, rate=0.1, seed=5)
    assert _count(lambda: tattn.flash_fwd(q, k, v, bias, lut, counts, **kw)) \
        == tattn.flash_fwd_flops(q, counts, blk)
    out, lse = tattn.flash_fwd(q, k, v, bias, lut, counts, **kw)
    delta = (do * out).sum(-1).reshape(B * H, S)
    assert _count(lambda: tattn.flash_bwd_dq(q, k, v, bias, do, lse, delta, lut, counts,
                                             **kw)) == tattn.flash_bwd_dq_flops(q, counts, blk)
    assert _count(lambda: tattn.flash_bwd_dkv(q, k, v, bias, do, lse, delta, qlut, qcounts,
                                              **kw)) \
        == tattn.flash_bwd_dkv_flops(q, qcounts, blk)


@pytest.mark.parametrize("C", [1, 5, 9])
def test_decode_and_band_formulas_equal_the_plain_versions(C):
    g = torch.Generator().manual_seed(1)
    P, nh, pt, hd, B, mp = 12, 2, 4, 16, 3, 3
    q = torch.randn(B, C, nh, hd, generator=g)
    pages = torch.randn(P, nh, pt, hd, generator=g)
    tables = torch.randint(0, P, (B, mp), dtype=torch.int32, generator=g)
    qpos = torch.randint(0, mp * pt, (B, C), dtype=torch.int32, generator=g)
    assert _count(lambda: tdecode.decode_attend(q, pages, pages, tables, qpos, page_tokens=pt,
                                                dtype=torch.float32)) \
        == tdecode.decode_attend_flops(q, tables, pt)
    N, W = 7 * C, 2 * pt
    qb = torch.randn(N, nh, hd, generator=g)
    kw, ks = torch.randn(N, nh, W, hd, generator=g), torch.randn(N, nh, pt, hd, generator=g)
    assert _count(lambda: tband.band_attend(qb, kw, kw, ks, ks, torch.arange(N),
                                            torch.zeros(N, dtype=torch.long),
                                            dtype=torch.float32)) \
        == tband.band_attend_flops(qb, kw, ks)


# -- tiny BERT against JAX's dot_general count --------------------------------------

def _dot_flops(jaxpr, mult=1):
    """The ``dot_general`` FLOPs of a jaxpr (JAX's ``_eqn_flops`` of each),
    walked into call primitives and scan bodies (times their length)."""
    total = 0
    for eqn in jaxpr.eqns:
        params = eqn.params or {}
        inner = params.get("jaxpr") or params.get("call_jaxpr")
        if inner is not None:
            m = mult * int(params.get("length", 1)) if eqn.primitive.name == "scan" else mult
            total += _dot_flops(getattr(inner, "jaxpr", inner), m)
        elif eqn.primitive.name == "dot_general":
            total += mult * jprof._eqn_flops(eqn)
    return total


def _recompute_term(B, H, S, D, L, flash):
    """The named difference of the backwards, port minus JAX. One
    attention product is 2·B·H·S²·D (the sequence is one block, so a
    block step is the whole product).

    - Composed path (S not a multiple of the 128 block, both packages):
      JAX's CPU VJP of ``_attention`` recomputes the forward's scores and
      PV products once a layer; the port's autograd reuses the forward's
      activations: -2 products a layer.
    - Flash path (S = 128): the port's plain dq version recomputes the
      scores and dO·Vᵀ and forms dS·K (3 products), its dk/dv version
      recomputes both again and forms Pᵀ·dO and dSᵀ·Q (4); JAX's CPU VJP
      recomputes the scores and PV, then takes the 4 products of their
      VJP (6): +1 product a layer."""
    product = 2 * B * H * S * S * D
    return (1 if flash else -2) * L * product


@pytest.mark.parametrize("seq", [32, 128])
def test_tiny_bert_matmul_flops_equal_jax_dot_general(seq):
    jcfg = dataclasses.replace(_tiny_bert_config(), max_position_embeddings=seq,
                               num_attention_heads=HEADS)
    fields = dataclasses.asdict(jcfg)
    fields.pop("scan_unroll")
    tcfg = BertConfig(**fields)
    batch = _bert_batch(2, seq, jcfg.vocab_size, 0)
    jmodel = JBert(jcfg)
    jb = tuple(jnp.asarray(x) for x in batch)
    params = jmodel.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                         *jb)

    def loss(p):
        return jmodel.apply(p, *jb, deterministic=True)

    jax_fwd = _dot_flops(jax.make_jaxpr(loss)(params).jaxpr)
    jax_both = _dot_flops(jax.make_jaxpr(jax.value_and_grad(loss))(params).jaxpr)

    model = BertForPreTraining.from_jax_params(_TO_NP(params), tcfg)
    tb = tuple(torch.from_numpy(x) for x in batch)
    prof = tprof.FlopsProfiler()
    fwd_only = prof.analyze(lambda: model(*tb, deterministic=True))
    both = prof.count_step(lambda: model(*tb, deterministic=True), lambda l: l.backward(),
                           params=model)
    assert fwd_only == jax_fwd
    B, H, D, L = 2, HEADS, jcfg.hidden_size // HEADS, jcfg.num_hidden_layers
    term = _recompute_term(B, H, seq, D, L, flash=seq % 128 == 0)
    assert (both - fwd_only) - (jax_both - jax_fwd) == term
    assert both - jax_both == term
    # the per-module table is the forward's and sums to it; params by owner
    assert sum(prof.module_flops.values()) == jax_fwd
    layer = "BertForPreTraining/bert/encoder/layers_1/qkv"
    assert prof.module_flops[layer] == 2 * 2 * seq * 64 * 3 * 64
    assert prof.module_params[layer] == 3 * 64 * 64 + 3 * 64
    assert sum(prof.module_params.values()) == sum(p.numel() for p in model.parameters())
    report = prof.print_model_profile(profile_step=1)
    assert "Top 3 modules in MACs at depth" in report and "layers_1" in report


def test_get_model_profile_of_a_forward():
    cfg = BertConfig(**{k: v for k, v in dataclasses.asdict(dataclasses.replace(
        _tiny_bert_config(), max_position_embeddings=32)).items() if k != "scan_unroll"})
    torch.manual_seed(0)
    model = dt.init_bert(cfg, seed=0, device="cpu")
    tb = tuple(torch.from_numpy(x) for x in _bert_batch(2, 32, cfg.vocab_size, 0))
    flops, macs, params = tprof.get_model_profile(model, args=tb, print_profile=False,
                                                  as_string=False)
    with torch.no_grad():
        assert flops == _count(lambda: model(*tb)) and macs == flops // 2
    assert params == sum(p.numel() for p in model.parameters())
    assert tprof.get_model_profile(model, args=tb, print_profile=False)[0].endswith("FLOPS")


# -- the engine -------------------------------------------------------------------

def _bert_engine(profile):
    jcfg = dataclasses.replace(_tiny_bert_config(), max_position_embeddings=128,
                               hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)
    fields = dataclasses.asdict(jcfg)
    fields.pop("scan_unroll")
    torch.manual_seed(0)
    model = dt.init_bert(BertConfig(**fields), seed=0, device="cpu")
    cfg = {"train_batch_size": 4, "gradient_accumulation_steps": 2,
           "optimizer": {"type": "Adam", "params": {"lr": 1e-3}}, "gradient_clipping": 1.0}
    if profile:
        cfg["flops_profiler"] = {"enabled": True, "profile_step": 1, "detailed": False}
    return dt.initialize(model=model, config=cfg, device="cpu")[0]


class _Recorder:
    def __init__(self):
        self.records = []

    def record(self, tag, value, step):
        self.records.append((tag, value, step))

    def flush(self):
        pass

    def close(self):
        pass


def test_profiled_run_equals_unprofiled_and_records_model_tflops():
    """Dropout on: the count pass puts the engine's random streams back
    and drops its gradients, so three profiled steps (the second one
    profiled) equal three unprofiled ones bit for bit."""
    batches = [tuple(torch.from_numpy(x) for x in _bert_batch(2, 128, 256, s))
               for s in range(6)]
    plain, profiled = _bert_engine(False), _bert_engine(True)
    profiled.monitor = _Recorder()
    want = [plain.train_batch(iter(batches[2 * i:2 * i + 2])) for i in range(3)]
    got = [profiled.train_batch(iter(batches[2 * i:2 * i + 2])) for i in range(3)]
    assert got == want
    for (name, a), b in zip(plain.master_params().items(), profiled.master_params().values()):
        assert torch.equal(a, b), name
    prof = profiled.last_profile
    assert prof["flops"] > 0 and prof["duration_s"] > 0 and prof["count_s"] > 0
    assert "FLOPs per step:" in prof["report"]
    assert prof["model_tflops"] == pytest.approx(prof["flops"] / prof["duration_s"] / 1e12)
    assert prof["mfu"] is None                                # no card, no peak
    tags = [(t, s) for t, _, s in profiled.monitor.records if "tflops" in t or "mfu" in t]
    assert tags == [("Train/Samples/model_tflops", 8)]
    with pytest.raises(AssertionError, match="fused train_step unavailable"):
        profiled.train_step(batches[:2])


def test_jax_engine_refuses_train_step_with_a_profiler_too():
    jcfg = dataclasses.replace(_tiny_bert_config(), max_position_embeddings=32)
    batch = tuple(jnp.asarray(x) for x in _bert_batch(2, 32, jcfg.vocab_size, 0))
    engine, _, _, _ = deepspeed_tpu.initialize(
        model=JBert(jcfg), config_params={
            "train_batch_size": 2, "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
            "flops_profiler": {"enabled": True}, "mesh": {"data_parallel_size": 1}},
        model_parameters=JBert(jcfg).init(
            {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, *batch))
    with pytest.raises(AssertionError, match="fused train_step unavailable"):
        engine.train_step([batch])


def test_a_kernel_note_counts_under_a_fresh_mode_and_lands_in_its_module():
    """The note every CUDA wrapper makes under a counting mode: counted by
    any ``FlopCounterMode`` (its formula is registered at import, before a
    mode copies the table) and attributed to the module it ran in."""
    from deepspeed_tpu_torch.kernels import registry

    class Attend(torch.nn.Module):
        def forward(self, x):
            if registry.counting_flops():
                registry.note_flops("flash_attention_fwd", x, 12345)
            return x

    outer = torch.nn.Sequential(Attend())
    with FlopCounterMode(display=False) as mode:
        outer(torch.ones(2))
    counts = mode.get_flop_counts()
    assert mode.get_total_flops() == 12345
    assert sum(counts["Sequential.0"].values()) == 12345
    assert not registry.counting_flops()


def test_counting_flops_only_under_a_flop_counter():
    """Another dispatch mode (selective checkpointing's, around every layer
    of a checkpointed step) does not count: a wrapper reports FLOPs only
    under a ``FlopCounterMode``, wherever it sits on the stack."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from deepspeed_tpu_torch.kernels import registry

    class Passthrough(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            return func(*args, **(kwargs or {}))

    with Passthrough():
        assert not registry.counting_flops()
        with FlopCounterMode(display=False):
            with Passthrough():
                assert registry.counting_flops()
    assert not registry.counting_flops()


def test_device_luts_carry_their_block_steps():
    """A LUT built for a device carries its block steps from the host, so a
    kernel's count reads nothing from the card (the meta device stands in
    for one here); counts built otherwise refuse to be counted."""
    from deepspeed_tpu_torch.ops.transformer import attention as fa

    H, S, block = 2, 64, 16
    layout = np.random.RandomState(0).randint(0, 2, (H, S // block, S // block))
    layout[:, np.arange(S // block), np.arange(S // block)] = 1
    q = torch.empty(1, H, S, 32, device="meta")
    for lay in (None, layout):
        host = fa._luts_for(None if lay is None else np.asarray(lay), H, S, block)
        dev = fa._device_luts(lay, H, S, block, torch.device("meta"))
        for counts, host_counts in zip(dev[1::2], host[1::2]):
            want = int(torch.from_numpy(np.asarray(host_counts)).max(0).values.sum())
            assert fa._lut_steps(counts) == want
        assert fa.flash_fwd_flops(q, dev[1], block) == \
            fa.flash_fwd_flops(q.new_empty(q.shape, device="cpu"),
                               torch.from_numpy(np.asarray(host[1])), block)
    with pytest.raises(ValueError, match="_device_luts"):
        fa._lut_steps(torch.ones(H, S // block, dtype=torch.int32, device="meta"))
