"""The port's LAMB, SGD and LR schedules, held against the JAX package.

N steps of each optimizer on the same fixed gradients from a numpy seed,
in every option combination below (bias correction, eps inside or
outside the square root, weight decay, trust-ratio clamps that bind at
both ends, a zero tensor whose trust ratio is 1; momentum, Nesterov and
weight decay for SGD), and every schedule's LR (and OneCycle's momentum)
over N steps.

Tolerances: optimizer parameters 1e-6 relative (the same fp32 math
summed in another order; the trust ratio's norms reduce in another
order); schedules exactly (both are the same Python float arithmetic).
"""

import itertools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from deepspeed_tpu.ops.lamb.fused_lamb import FusedLamb as JLamb  # noqa: E402
from deepspeed_tpu.ops.sgd import SGD as JSGD  # noqa: E402
from deepspeed_tpu.runtime import lr_schedules as jsched  # noqa: E402
from deepspeed_tpu_torch.ops.lamb.fused_lamb import FusedLamb  # noqa: E402
from deepspeed_tpu_torch.ops.sgd import SGD  # noqa: E402
from deepspeed_tpu_torch.runtime import lr_schedules as tsched  # noqa: E402

SHAPES = {"w": (6, 5), "b": (5,), "tiny": (3, 3), "zero": (4,)}


def _run(jopt, topt, steps=6, seed=21, scales=None):
    """``steps`` updates of both optimizers on the same gradients; the
    parameters must agree after every step."""
    rng = np.random.RandomState(seed)
    scales = scales or {}
    params = {k: (rng.randn(*s) * scales.get(k, 1.0)).astype(np.float32)
              for k, s in SHAPES.items()}
    params["zero"][:] = 0.0            # ||w|| = 0: trust ratio 1
    names = list(SHAPES)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = [torch.from_numpy(params[k].copy()) for k in names]
    jstate, tstate = jopt.init(jp), topt.init(tp)
    for _ in range(steps):
        grads = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
        jp, jstate = jopt.update({k: jnp.asarray(v) for k, v in grads.items()}, jstate, jp,
                                 lr=jnp.asarray(3e-2, jnp.float32))
        topt.update([torch.from_numpy(grads[k]) for k in names], tstate, tp, lr=3e-2,
                    names=names)
        for k, t in zip(names, tp):
            np.testing.assert_allclose(t.numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7,
                                       err_msg=k)
    assert tstate.step == int(jstate.step) == steps


@pytest.mark.parametrize("bias_correction,eps_inside_sqrt,weight_decay",
                         list(itertools.product([True, False], [False, True], [0.0, 0.01])))
def test_fused_lamb_matches_jax(bias_correction, eps_inside_sqrt, weight_decay):
    kw = dict(bias_correction=bias_correction, eps_inside_sqrt=eps_inside_sqrt,
              weight_decay=weight_decay, betas=(0.9, 0.99), eps=1e-6)
    _run(JLamb(**kw), FusedLamb(**kw))


def test_fused_lamb_trust_ratio_clamps_bind_at_both_ends():
    """``w`` is large (ratio above max_coeff), ``tiny`` small (below
    min_coeff), ``zero`` has norm 0 (ratio 1)."""
    kw = dict(max_coeff=0.3, min_coeff=0.05, weight_decay=0.01)
    _run(JLamb(**kw), FusedLamb(**kw), scales={"w": 50.0, "tiny": 1e-4})


@pytest.mark.parametrize("momentum,nesterov,weight_decay",
                         [(0.0, False, 0.0), (0.9, False, 0.0), (0.9, True, 0.0),
                          (0.9, True, 1e-2), (0.0, False, 1e-2)])
def test_sgd_matches_jax(momentum, nesterov, weight_decay):
    kw = dict(momentum=momentum, nesterov=nesterov, weight_decay=weight_decay)
    _run(JSGD(**kw), SGD(**kw))


def test_lamb_and_sgd_refuse_what_jax_refuses():
    with pytest.raises(RuntimeError, match="AMSGrad"):
        FusedLamb(amsgrad=True)
    for cls in (FusedLamb, SGD):
        with pytest.raises(ValueError, match="no_decay_names"):
            cls(no_decay_names=["bias"])
    assert (FusedLamb().name, SGD().name) == ("lamb", "sgd")


SCHEDULES = {
    "LRRangeTest": dict(lr_range_test_min_lr=0.01, lr_range_test_step_size=4,
                        lr_range_test_step_rate=0.5),
    "LRRangeTest staircase": dict(lr_range_test_min_lr=0.01, lr_range_test_step_size=4,
                                  lr_range_test_step_rate=0.5, lr_range_test_staircase=True),
    "OneCycle": dict(cycle_min_lr=0.001, cycle_max_lr=0.1, cycle_first_step_size=6,
                     cycle_second_step_size=4, decay_lr_rate=0.1, decay_step_size=2,
                     cycle_min_mom=0.8, cycle_max_mom=0.95, decay_mom_rate=0.05),
    "WarmupLR": dict(warmup_min_lr=0.001, warmup_max_lr=0.1, warmup_num_steps=7),
    "WarmupDecayLR": dict(total_num_steps=20, warmup_min_lr=0.0, warmup_max_lr=0.1,
                          warmup_num_steps=5),
}


@pytest.mark.parametrize("case", list(SCHEDULES))
def test_schedules_match_jax(case):
    name = case.split()[0]
    j = jsched.get_lr_schedule(name, SCHEDULES[case])
    t = tsched.get_lr_schedule(name, SCHEDULES[case])
    assert type(t).__name__ == type(j).__name__
    assert t.get_lr() == j.get_lr()            # before the first step
    for i in range(25):
        assert t.step() == j.step(), i
        assert t.get_last_lr() == j.get_last_lr()
        if name == "OneCycle":
            assert t.get_mom() == j.get_mom(), i
    # state_dict round trip: a fresh schedule picks up where this one is
    sd = t.state_dict()
    assert sd == j.state_dict()
    back = tsched.get_lr_schedule(name, SCHEDULES[case])
    back.load_state_dict(sd)
    assert back.step() == t.step() == j.step()
    with pytest.raises(ValueError):
        tsched.get_lr_schedule("Nonsense", {})
