"""The port's data loader, held against the JAX package's on the CPU.

``DistributedSampler`` + ``DeepSpeedDataLoader`` must hand out the same
samples in the same batches and order as the JAX loader (shuffle on and
off, one and two replicas, a ragged dataset padded to the replicas),
exactly; ``RepeatingLoader`` must restart with the next epoch's order;
``PrefetchLoader`` must yield the source's items in order, raise the
source's errors in order with their own traceback, and stop its worker
on ``close()``. The engine's ``deepspeed_io`` and ``training_data=``
are covered by the engine trajectories of ``test_torch_fp16.py``.
"""

import threading
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from deepspeed_tpu.runtime import dataloader as J  # noqa: E402
from deepspeed_tpu_torch.runtime import dataloader as T  # noqa: E402


class _Dataset:
    """Samples of (features, label), the label the sample's index."""

    def __init__(self, n, seed=0):
        self.x = np.random.RandomState(seed).randn(n, 3).astype(np.float32)

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return self.x[i], np.int64(i)


def _equal(tbatches, jbatches):
    assert len(tbatches) == len(jbatches) > 0
    for tb, jb in zip(tbatches, jbatches):
        assert len(tb) == len(jb)
        for t, j in zip(tb, jb):
            assert isinstance(t, torch.Tensor)
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("replicas", [1, 2])
def test_loader_batches_match_jax(shuffle, replicas):
    data = _Dataset(23)          # 23 samples: the sampler pads to the replicas
    for rank in range(replicas):
        kw = dict(batch_size=4, num_replicas=replicas, rank=rank, shuffle=shuffle, seed=7)
        tl, jl = T.DeepSpeedDataLoader(data, **kw), J.DeepSpeedDataLoader(data, **kw)
        assert len(tl) == len(jl)
        for epoch in range(2):
            tl.data_sampler.set_epoch(epoch)
            jl.data_sampler.set_epoch(epoch)
            _equal(list(tl), list(jl))
    seen = [int(i) for rank in range(replicas)
            for i in T.DistributedSampler(23, replicas, rank, shuffle=shuffle, seed=7)]
    assert sorted(set(seen)) == list(range(23))


def test_loader_collates_dicts_and_custom_fns():
    data = [{"a": np.arange(2) + i, "b": i} for i in range(6)]
    tb = next(iter(T.DeepSpeedDataLoader(data, batch_size=3)))
    jb = next(iter(J.DeepSpeedDataLoader(data, batch_size=3)))
    assert tb.keys() == jb.keys()
    for k in tb:
        np.testing.assert_array_equal(tb[k].numpy(), jb[k])
    total = lambda samples: sum(int(s["b"]) for s in samples)
    assert next(iter(T.DeepSpeedDataLoader(data, batch_size=3, collate_fn=total))) == 3


def test_repeating_loader_restarts_with_the_next_epoch():
    data = _Dataset(8)
    kw = dict(batch_size=4, shuffle=True, seed=3)
    tr = T.RepeatingLoader(T.DeepSpeedDataLoader(data, **kw))
    jr = J.RepeatingLoader(J.DeepSpeedDataLoader(data, **kw))
    _equal([next(tr) for _ in range(6)], [next(jr) for _ in range(6)])
    assert tr.loader.data_sampler.epoch == jr.loader.data_sampler.epoch == 2
    plain = T.RepeatingLoader([1, 2])
    assert [next(plain) for _ in range(5)] == [1, 2, 1, 2, 1]


def test_prefetch_loader_order_errors_and_end():
    data = [torch.full((2,), float(i)) for i in range(5)]
    out = list(T.PrefetchLoader(iter(data), depth=2))
    assert [float(b[0]) for b in out] == [0.0, 1.0, 2.0, 3.0, 4.0]

    def failing():
        yield 1
        yield 2
        raise KeyError("boom")

    it = iter(T.PrefetchLoader(failing(), depth=3))
    assert (next(it), next(it)) == (1, 2)
    with pytest.raises(KeyError, match="boom") as info:
        next(it)
    # the traceback names the source's own frame
    assert any(f.name == "failing" for f in info.traceback)
    with pytest.raises(StopIteration):      # latched after an error
        next(it)
    with pytest.raises(ValueError, match="depth"):
        T.PrefetchLoader([], depth=0)
    cpu = T.PrefetchLoader([(torch.ones(2),)], device="cpu")
    assert torch.equal(next(cpu)[0], torch.ones(2)) and len(cpu) == 1


def test_prefetch_loader_runs_ahead_and_close_stops_the_worker():
    produced = []

    def gen():
        for i in range(1000):
            produced.append(i)
            yield i

    pf = T.PrefetchLoader(gen(), depth=3)
    assert next(pf) == 0
    deadline = time.monotonic() + 5
    while len(produced) < 4 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert len(produced) == 4          # one consumed, three queued, then blocked
    pf.close()
    assert not pf._thread.is_alive() and pf._queue.empty()
    with pytest.raises(StopIteration):
        next(pf)
    pf.close()                         # idempotent
    assert len(produced) < 10

    gate = threading.Event()

    def blocked():
        gate.wait()
        yield 1

    stuck = T.PrefetchLoader(blocked(), depth=1)
    iter(stuck)
    t0 = time.monotonic()
    stuck.close(timeout=0.2)           # the source is stuck in next(): abandoned
    assert time.monotonic() - t0 < 2.0
    gate.set()
    with T.PrefetchLoader(iter([1, 2])) as ctx:
        assert next(ctx) == 1
    assert ctx._done
