"""The ``fleet`` block in the port against the JAX package: the same dicts
give the same dataclasses field for field, and the same bad dicts raise
the same errors with the same messages, through ``DeepSpeedConfig`` and
through the sub-block parsers the replica calls."""

import dataclasses

import pytest

pytest.importorskip("jax")

from deepspeed_tpu.inference.serving import config as jserving_config  # noqa: E402
from deepspeed_tpu.runtime import config as jconfig  # noqa: E402
from deepspeed_tpu_torch.inference.serving import config as tserving_config  # noqa: E402
from deepspeed_tpu_torch.runtime import config as tconfig  # noqa: E402

FLEETS = [
    {},
    {"replicas": 4, "retry_budget": 3, "max_inflight_tokens": {"default": 4096, "bulk": 1024}},
    {"enabled": False, "attempt_timeout_s": 0, "affinity_prefix_tokens": 0},
    {"autoscale": {"min_replicas": 2, "max_replicas": 6, "warm_spares": 0, "up_after_s": 0.5}},
    {"degrade": {"escalate_after_s": 0.1, "pressure_queue_frac": 0.5,
                 "shed_classes": ["bulk", "batch"]}},
    {"breaker": {"threshold": 5, "window_s": 10, "cooldown_s": 1}},
    {"rollout": {"canary_fraction": 0.25, "shadow_sample_rate": 0.0,
                 "rollback_on": ["slo_alert"], "min_canary_requests": 2}},
    {"roles": {"prefill_replicas": 2, "decode_replicas": 3, "max_decode_replicas": 5}},
    {"handoff": {"max_frame_bytes": 1 << 27, "retries": 5, "claim_ttl_s": 1.5}},
    {"autoscale": {"enabled": False}, "handoff": {}, "roles": {}, "rollout": {}},
]

BAD_FLEETS = [
    {"replicas": 0},
    {"retry_budget": -1},
    {"retry_backoff_s": "fast"},
    {"saturation_queue_depth": 0},
    {"max_inflight_tokens": {"x": -5}},
    {"max_inflight_tokens": 1.5},
    {"autoscale": {"min_replicas": 5, "max_replicas": 2}},
    {"autoscale": []},
    {"degrade": {"pressure_queue_frac": 1.5}},
    {"degrade": {"shed_classes": "bulk"}},
    {"breaker": {"threshold": 0}},
    {"rollout": {"canary_fraction": 2.0}},
    {"rollout": {"rollback_on": ["bogus"]}},
    {"roles": {"prefill_replicas": -1}},
    {"handoff": {"retries": 0}},
    {"handoff": {"max_frame_bytes": 0}},
]


def _parse(module, fleet):
    try:
        cfg = module.DeepSpeedConfig({"train_batch_size": 1, "fleet": fleet}, world_size=1)
    except Exception as e:       # compared by type and message
        return type(e).__name__, str(e)
    return dataclasses.asdict(cfg.fleet_config)


@pytest.mark.parametrize("fleet", FLEETS)
def test_fleet_block_parses_as_jax_does(fleet):
    ours = _parse(tconfig, fleet)
    assert isinstance(ours, dict)
    assert ours == _parse(jconfig, fleet)


@pytest.mark.parametrize("fleet", BAD_FLEETS)
def test_bad_fleet_block_raises_as_jax_does(fleet):
    ours = _parse(tconfig, fleet)
    assert isinstance(ours, tuple), f"accepted {fleet}"
    assert ours == _parse(jconfig, fleet)


def test_absent_fleet_block_is_disabled():
    cfg = tconfig.DeepSpeedConfig({"train_batch_size": 1}, world_size=1)
    assert not cfg.fleet_config.enabled
    assert cfg.fleet_config == tserving_config.FleetConfig()


@pytest.mark.parametrize("name", ["AutoscaleConfig", "DegradeConfig", "BreakerConfig",
                                  "RolloutConfig", "RolesConfig", "HandoffConfig",
                                  "FleetConfig"])
def test_fleet_dataclasses_equal_jax_field_for_field(name):
    ours = getattr(tserving_config, name)
    theirs = getattr(jserving_config, name)
    def fields(cls):    # sub-block types by name: each package has its own classes
        return [(f.name, getattr(f.type, "__name__", f.type), f.default)
                for f in dataclasses.fields(cls)]
    assert fields(ours) == fields(theirs)
    assert dataclasses.asdict(ours()) == dataclasses.asdict(theirs())


@pytest.mark.parametrize("handoff", [{}, {"retries": 7, "backoff_s": 0.5}, {"retries": 0}])
def test_handoff_parser_the_replica_calls(handoff):
    """``replica_main`` parses a spec's ``fleet.handoff`` alone."""
    def parse(module):
        try:
            return dataclasses.asdict(module._get_fleet_handoff({"handoff": handoff}))
        except ValueError as e:
            return str(e)
    assert parse(tconfig) == parse(jconfig)


def test_serving_mesh_knobs_stay_refused():
    """The tensor-parallel mesh knobs are no longer refused: they are
    ``ServingConfig`` fields with the JAX package's defaults, and the
    engine arms its mesh from them (tests/test_torch_serving_tp.py)."""
    assert not hasattr(tserving_config, "UNPORTED_KNOBS")
    for knob in ("mesh_shape", "partition_rules", "replicate_unmatched"):
        assert getattr(tserving_config.ServingConfig(), knob) == \
            getattr(jserving_config.ServingConfig(), knob), knob
