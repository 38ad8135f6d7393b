"""The config keys the JAX ``DeepSpeedConfig`` parses beside its sections
(``amp``, ``allreduce_always_fp32``, ``disable_allgather``, ``dump_state``
and the optimizer's ``legacy_fusion``), held to the JAX package's parse
on the same dicts, with the engine accessors that read them, and the
sections the port still refuses by name."""

import pytest

pytest.importorskip("jax")

import deepspeed_tpu_torch as dt  # noqa: E402
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JConfig  # noqa: E402
from deepspeed_tpu_torch.runtime import constants as tconstants  # noqa: E402
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig  # noqa: E402

from test_torch_sentinels import _Linear  # noqa: E402

_KEYS = ("amp_enabled", "amp_params", "allreduce_always_fp32", "disable_allgather",
         "dump_state", "optimizer_legacy_fusion")
_OPT = {"type": "Adam", "params": {"lr": 1e-3}}


@pytest.mark.parametrize("extra", [
    {},
    {"amp": {"enabled": True, "opt_level": "O1", "loss_scale": "dynamic"}},
    {"amp": {"opt_level": "O2"}},
    {"amp": {"enabled": False}},
    {"allreduce_always_fp32": True, "disable_allgather": True, "dump_state": True},
    {"optimizer": dict(_OPT, legacy_fusion=True)},
    {"optimizer": dict(_OPT, legacy_fusion=False), "dump_state": False},
])
def test_keys_parse_as_jax_does(extra):
    cfg = {"train_batch_size": 4, "optimizer": _OPT, **extra}
    got, want = DeepSpeedConfig(dict(cfg), world_size=1), JConfig(dict(cfg), world_size=1)
    for key in _KEYS:
        assert getattr(got, key) == getattr(want, key), key
    engine = dt.initialize(model=_Linear(), config=dict(cfg), device="cpu")[0]
    assert engine.allreduce_always_fp32() == want.allreduce_always_fp32
    assert engine.optimizer_legacy_fusion() == want.optimizer_legacy_fusion


def test_only_curriculum_and_sparse_gradients_are_still_refused():
    assert tconstants.UNPORTED_SECTIONS == ("curriculum_learning", "sparse_gradients")
    for section in ({"amp": {"enabled": True}}, {"flops_profiler": {"enabled": True}},
                    {"jax_sentinels": {"enabled": True}}, {"sentinel": {"enabled": True}}):
        DeepSpeedConfig({"train_batch_size": 4, **section}, world_size=1)
    for section in ({"curriculum_learning": {"enabled": True}}, {"sparse_gradients": True}):
        with pytest.raises(NotImplementedError, match="not ported"):
            DeepSpeedConfig({"train_batch_size": 4, **section}, world_size=1)
