"""Sharded model construction for ZeRO-3 (port of
``deepspeed_tpu/runtime/zero/init.py``).

A model too large to build whole on one rank is built on the ``meta``
device, which allocates nothing, and each parameter is then materialized
alone: its full initial value is drawn (from the same generator, in the
same order as the unsharded initializer, so the values are those a whole
``init_bert(seed)`` gives), this rank keeps its dim-0 shard, and the full
leaf is dropped before the next one is drawn. Only one leaf is ever whole;
the model never is. Parameters stage 3 keeps whole (dim 0 not divisible
by the world) are kept whole. The result goes straight into
``initialize`` with ``"zero_optimization": {"stage": 3}``.

    model = zero3_sharded_init(lambda: BertForPreTraining(cfg), bert_init_plan,
                               seed=0, device="cuda")
"""

import torch
from torch import nn

from deepspeed_tpu_torch.models.gpt2 import resolve_device
from deepspeed_tpu_torch.runtime.zero.sharded_optimizer import zero3_param_shardings
from deepspeed_tpu_torch.utils.distributed import group_rank_and_size


def zero3_sharded_init(model_fn, init_plan, seed=0, device="cuda", dtype=torch.float32):
    """Build ``model_fn()`` with every eligible parameter born as this
    rank's dim-0 shard of the running process group (whole at world 1).
    ``init_plan(model, generator)`` lists ``(parameter, fill)`` in draw
    order (``models.bert.bert_init_plan``). A sharded parameter carries its
    full shape as ``ds_shape``."""
    device = resolve_device(device)
    rank, world = group_rank_and_size()
    with torch.device("meta"):
        model = model_fn()
    owner = {id(p): (mod, name) for mod in model.modules()
             for name, p in mod.named_parameters(recurse=False)}
    gen = torch.Generator(device=device).manual_seed(int(seed))
    plan = init_plan(model, gen)
    assert len({id(p) for p, _ in plan}) == len(owner), "the plan must fill every parameter"
    sharded = zero3_param_shardings([tuple(p.shape) for p, _ in plan], world)
    with torch.no_grad():
        for (meta, fill), shard_it in zip(plan, sharded):
            full = torch.empty(meta.shape, dtype=torch.float32, device=device)
            fill(full)
            if shard_it:
                rows = meta.shape[0] // world
                value = full[rank * rows:(rank + 1) * rows].to(dtype).clone()
            else:
                value = full.to(dtype)
            del full
            param = nn.Parameter(value, requires_grad=meta.requires_grad)
            if shard_it:
                param.ds_shape = tuple(meta.shape)
            mod, name = owner[id(meta)]
            mod._parameters[name] = param
    return model
