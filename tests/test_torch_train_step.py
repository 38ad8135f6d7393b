"""Oracles of the port's training step, inside the port (the counterparts
of the JAX package's tests/unit/test_engine_vs_plain_jax.py and
tests/unit/test_train_step.py).

- The engine against a hand loop (autograd and ``FusedAdam``, no engine):
  at fp32 and gas 1 the engine adds nothing to the math, so losses and
  parameters agree bit for bit.
- The fused ``train_step`` against the three-call ``forward`` /
  ``backward`` / ``step`` over gas 1 and 2 in fp32, bf16, fp16 (static
  scale 128) and ZeRO-2: the same operations in the same order, so the
  parameters agree bit for bit; the fused step's loss is the mean of its
  microbatch losses in fp32, the loop's their mean in fp64, so losses
  agree to 1e-6 relative.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import deepspeed_tpu_torch as dt
from deepspeed_tpu_torch.ops.adam.fused_adam import FusedAdam

HID = 16
LR = 1e-2


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Tiny tensors gain nothing from many threads; the test workers
    share the machine."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


class SimpleModel(torch.nn.Module):
    """Two dense layers and a mean squared error, inputs cast to the
    weights' dtype."""

    def __init__(self, hidden=HID, seed=3):
        super().__init__()
        torch.manual_seed(seed)
        self.fc1 = torch.nn.Linear(hidden, hidden)
        self.fc2 = torch.nn.Linear(hidden, hidden)

    def forward(self, x, y):
        x = x.to(self.fc1.weight.dtype)
        out = self.fc2(torch.relu(self.fc1(x)))
        return F.mse_loss(out.float(), y.float())


def _data(gas, steps, seed=0):
    rng = np.random.RandomState(seed)
    return [[(rng.randn(8, HID).astype(np.float32), rng.randn(8, HID).astype(np.float32))
             for _ in range(gas)] for _ in range(steps)]


def _cfg(gas=1, **over):
    cfg = {"train_batch_size": 8 * gas, "train_micro_batch_size_per_gpu": 8,
           "gradient_accumulation_steps": gas,
           "optimizer": {"type": "Adam", "params": {"lr": LR}}, "gradient_clipping": 1.0}
    cfg.update(over)
    return cfg


def _make(cfg, model=None):
    engine, _, _, _ = dt.initialize(model=model or SimpleModel(), config=cfg, device="cpu")
    return engine


def test_engine_matches_hand_loop():
    data = [step[0] for step in _data(1, 6, seed=7)]
    model = SimpleModel()
    opt = FusedAdam(lr=LR)
    params = list(model.parameters())
    state = opt.init(params)
    hand = []
    for x, y in data:
        loss = model(torch.from_numpy(x), torch.from_numpy(y))
        grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            opt.update(list(grads), state, params, lr=LR)
        hand.append(float(loss))
    engine = _make({"train_batch_size": 8, "optimizer": {"type": "Adam",
                                                         "params": {"lr": LR}}})
    got = [float(engine.train_step([(x, y)])) for x, y in data]
    assert got == hand
    for (name, p), q in zip(engine.module.named_parameters(), params):
        assert torch.equal(p.detach(), q.detach()), name


PRECISIONS = {"fp32": {}, "bf16": {"bf16": {"enabled": True}},
              "fp16": {"fp16": {"enabled": True, "loss_scale": 128.0}},
              "zero2": {"zero_optimization": {"stage": 2}}}


@pytest.mark.parametrize("gas", [1, 2])
@pytest.mark.parametrize("precision", list(PRECISIONS))
def test_fused_matches_three_call(gas, precision):
    data = _data(gas, steps=4)
    fused = _make(_cfg(gas, **PRECISIONS[precision]))
    fused_losses = [float(fused.train_step(step)) for step in data]
    loop = _make(_cfg(gas, **PRECISIONS[precision]))
    loop_losses = []
    for step in data:
        per = []
        for mb in step:
            loss = loop(*mb)
            loop.backward(loss)
            per.append(float(loss))
            loop.step()
        loop_losses.append(float(np.mean(per)))
    np.testing.assert_allclose(fused_losses, loop_losses, rtol=1e-6)
    for (name, a), b in zip(fused.master_params().items(), loop.master_params().values()):
        assert torch.equal(a, b), name
    for (name, a), b in zip(fused.module.named_parameters(), loop.module.parameters()):
        assert torch.equal(a.detach(), b.detach()), name
    assert fused.global_steps == loop.global_steps == 4
    assert fused.micro_steps == loop.micro_steps == gas * 4


def test_fused_lr_schedule_advances():
    engine = _make(_cfg(1, scheduler={"type": "WarmupLR",
                                      "params": {"warmup_min_lr": 0.0, "warmup_max_lr": 1e-2,
                                                 "warmup_num_steps": 10}}))
    lrs = []
    for step in _data(1, steps=3):
        engine.train_step(step)
        lrs.append(engine.get_lr()[0])
    assert lrs[0] < lrs[1] < lrs[2]


def test_fused_fp16_overflow_skips():
    engine = _make(_cfg(1, fp16={"enabled": True}))
    before = [p.detach().clone() for p in engine.module.parameters()]
    x = np.full((8, HID), 1e30, np.float32)   # inf in fp16: the gradients overflow
    engine.train_step([(x, np.zeros((8, HID), np.float32))])
    assert engine.skipped_steps == 1
    assert all(torch.equal(p.detach(), b) for p, b in zip(engine.module.parameters(), before))


class MultiOut(torch.nn.Module):
    def __init__(self):
        super().__init__()
        torch.manual_seed(0)
        self.h = torch.nn.Linear(16, 16)
        self.o1, self.o2 = torch.nn.Linear(16, 16), torch.nn.Linear(16, 16)

    def forward(self, x, y1, y2):
        h = torch.relu(self.h(x))
        l1 = torch.mean((self.o1(h) - y1) ** 2)
        l2 = torch.mean((self.o2(h) - y2) ** 2)
        return 0.7 * l1 + 0.3 * l2, (l1, l2)


def test_multi_output_model():
    """A model returning (loss, aux) trains on the first element."""
    rng = np.random.RandomState(0)
    x, y1, y2 = (rng.randn(8, 16).astype(np.float32) for _ in range(3))
    engine = _make({"train_batch_size": 8, "optimizer": {"type": "Adam",
                                                         "params": {"lr": 1e-2}}},
                   model=MultiOut())
    losses = []
    for _ in range(6):
        loss = engine(x, y1, y2)
        assert loss.shape == ()
        engine.backward(loss)
        engine.step()
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.8, losses
