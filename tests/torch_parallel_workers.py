"""Rank processes for the port's tensor, sequence and expert parallelism
tests (``tests/test_torch_parallel.py``, ``test_torch_zero_tp.py``,
``test_torch_moe.py``, ``test_torch_onebit_adam.py``).

The tests compute the JAX package's answers in the pytest process, save
the inputs, and ``spawn`` starts ``world`` processes that meet over gloo
in a ``FileStore`` under the test's directory, run the port and save what
they got. This module imports no JAX, so a rank process starts without it.
"""

import os
import time

import numpy as np
import torch
import torch.multiprocessing as mp

TIMEOUT_S = 120


def spawn(fn, world, tmp_path, *args, timeout_s=TIMEOUT_S):
    """Run ``fn(rank, world, *args)`` in ``world`` processes over gloo;
    returns each rank's return value (saved with ``torch.save``)."""
    ctx = mp.start_processes(_entry, args=(world, str(tmp_path), fn, args), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{fn.__name__} at world {world} did not finish "
                               f"within {timeout_s} s")
    return [torch.load(os.path.join(str(tmp_path), f"out{r}.pt"), weights_only=False)
            for r in range(world)]


def _entry(rank, world, out_dir, fn, args):
    torch.set_num_threads(1)
    store = torch.distributed.FileStore(os.path.join(out_dir, "store"), world)
    torch.distributed.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        out = fn(rank, world, *args)
        torch.save(out, os.path.join(out_dir, f"out{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def _t(x, requires_grad=False):
    t = torch.from_numpy(np.array(x))
    return t.requires_grad_(requires_grad) if requires_grad else t


# ---------------------------------------------------------------------------
# tests/test_torch_parallel.py: TP layer, ring / Ulysses, registry, BERT TP 2
# ---------------------------------------------------------------------------

def layer_from_jax(tree, cfg):
    """A ``DeepSpeedTransformerLayer`` from one flax layer's numpy tree."""
    from deepspeed_tpu_torch.models.bert import _dense, _norm
    from deepspeed_tpu_torch.ops.transformer.transformer import DeepSpeedTransformerLayer

    layer = DeepSpeedTransformerLayer(cfg)
    with torch.no_grad():
        for name in ("qkv", "attn_out", "ff1", "ff2"):
            _dense(getattr(layer, name), tree[name])
        for name in ("ln_attn", "ln_ffn"):
            _norm(getattr(layer, name), tree[name])
    return layer


def ring_plain(q, k, v, mask=None, group=None, causal=False):
    """The ring's plain version (JAX's partial-and-merge) on whole tensors,
    through the chunking of ``ring_attention``."""
    from deepspeed_tpu_torch.parallel import sequence

    B, H, S, D = q.shape
    bias = sequence.seq_chunk(sequence._key_bias(mask, B, S, q.device), group, 1)
    qc, kc, vc = (sequence.seq_chunk(t, group, 2) for t in (q, k, v))
    out = sequence.ring_attention_plain(qc, kc, vc, bias, group, causal)
    return sequence.seq_unchunk(out, group, 2)


def parallel_worker(rank, world, inputs):
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.parallel import mesh as mesh_lib, tp
    from deepspeed_tpu_torch.parallel import sequence
    from deepspeed_tpu_torch.parallel.sharding_registry import serving_registry
    from deepspeed_tpu_torch.parallel.ulysses import ulysses_attention

    out = {}
    mesh = mesh_lib.create_mesh(model_parallel_size=world)
    group = mesh.group("model")
    out["mpu"] = dict(mp=mesh_lib.MeshMpu(mesh).get_model_parallel_world_size(),
                      mp_rank=mesh_lib.MeshMpu(mesh).get_model_parallel_rank(),
                      dp=mesh_lib.MeshMpu(mesh).get_data_parallel_world_size())

    # the TP layer against JAX's (forward, input and parameter gradients)
    lay = inputs["layer"]
    layer = layer_from_jax(lay["params"], lay["cfg"])
    tp.shard_params(layer, mesh)
    x = _t(lay["x"], True)
    y = layer(x, None, True)
    (y * _t(lay["dy"])).sum().backward()
    out["layer"] = dict(y=y.detach(), dx=x.grad, grads={
        k: v.grad if k not in tp.sharded_params(layer) else
        tp.whole_of(v.grad, *tp.sharded_params(layer)[k][:1], group,
                    tp.sharded_params(layer)[k][1])
        for k, v in layer.named_parameters()})

    # shard_params, then gather_params: JAX's weights come back whole
    round_trip = layer_from_jax(lay["params"], lay["cfg"])
    tp.shard_params(round_trip, mesh)
    out["gathered"] = tp.gather_params(round_trip)

    # dropout at TP 2 draws TP 1's bits: the same layer whole, with dropout
    cfg_d = lay["cfg_dropout"]
    whole = layer_from_jax(lay["params"], cfg_d)
    split = layer_from_jax(lay["params"], cfg_d)
    tp.shard_params(split, mesh)
    xd = _t(lay["x"])
    out["dropout"] = float((whole(xd, None, False, 123) - split(xd, None, False, 123))
                           .abs().max())

    # ring and Ulysses on whole tensors against JAX's
    seq = {}
    for name, case in inputs["seq"].items():
        q, k, v = (_t(case[n], True) for n in ("q", "k", "v"))
        mask = None if case["bias"] is None else _t(case["bias"])
        fn = {"ring": ring_plain, "ulysses": ulysses_attention,
              "ring_flash": sequence.ring_attention}[case["fn"]]
        o = fn(q, k, v, mask=mask, group=group, causal=case["causal"])
        (o * _t(case["g"])).sum().backward()
        seq[name] = dict(out=o.detach(), dq=q.grad, dk=k.grad, dv=v.grad)
    out["seq"] = seq

    # the registry's shard / gather round trip over the model group
    reg = serving_registry()
    tree = {"h": {k: _t(v) for k, v in inputs["tree"].items()}}
    sharded = reg.shard(mesh, tree)
    back = reg.gather(mesh, sharded)
    out["registry"] = dict(shapes={k: tuple(v.shape) for k, v in sharded["h"].items()},
                           equal=all(torch.equal(back["h"][k], tree["h"][k])
                                     for k in tree["h"]))
    out["a2a"] = comm.all_to_all(torch.arange(8.0).reshape(4, 2) + 10 * rank, group, 0, 1)
    return out


def bert_engine_run(spec, rank, steps=3):
    """``steps`` train steps of BERT from JAX weights through initialize();
    losses (this data rank's rows) and the whole masters."""
    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.models.bert import BertForPreTraining

    model = BertForPreTraining.from_jax_params(spec["params"], spec["cfg"])
    engine, _, _, _ = dt.initialize(model=model, config=dict(spec["ds_config"]), device="cpu")
    dp, r = engine.dp_world_size, engine.mesh.rank("data")
    rows = spec["batch"][0].shape[0] // dp
    batch = tuple(_t(b)[r * rows:(r + 1) * rows] for b in spec["batch"])
    losses = [float(engine.train_step([batch])) for _ in range(steps)]
    return dict(losses=losses, masters={k: v.clone() for k, v in engine.master_params().items()},
                dp=dp, mp=engine.mp_world_size)


# ---------------------------------------------------------------------------
# tests/test_torch_zero_tp.py: the MLP of tests/unit/test_zero_tp.py at 2 x 2
# ---------------------------------------------------------------------------

class MLP(torch.nn.Module):
    """The flax MLP of ``tests/unit/test_zero_tp.py``: ff1 (8 -> 32), relu,
    ff2 (32 -> 8), mean squared error."""

    def __init__(self, params=None):
        super().__init__()
        self.ff1 = torch.nn.Linear(8, 32)
        self.ff2 = torch.nn.Linear(32, 8)
        if params is not None:
            from deepspeed_tpu_torch.models.bert import _dense

            with torch.no_grad():
                _dense(self.ff1, params["ff1"])
                _dense(self.ff2, params["ff2"])

    def forward(self, x, y):
        pred = self.ff2(torch.relu(self.ff1(x)))
        return ((pred - y) ** 2).mean()


def mlp_engine(spec, extra=None):
    import deepspeed_tpu_torch as dt

    cfg = dict(spec["ds_config"])
    cfg.update(extra or {})
    engine, _, _, _ = dt.initialize(model=MLP(spec["params"]), config=cfg, device="cpu")
    r, dp = engine.mesh.rank("data"), engine.dp_world_size
    rows = spec["x"].shape[0] // dp
    batch = (_t(spec["x"])[r * rows:(r + 1) * rows], _t(spec["y"])[r * rows:(r + 1) * rows])
    return engine, batch


def zero_tp_worker(rank, world, spec, ckpt_dir):
    out = {}
    engine, batch = mlp_engine(spec)
    losses = []
    for _ in range(4):
        loss = engine(*batch)
        engine.backward(loss)
        engine.step()
        losses.append(float(loss))
    opt = engine.optimizer
    out["mlp"] = dict(losses=losses, dims=dict(zip(opt.names, opt.dims)),
                      tp={n: (t[0] if t else None) for n, t in zip(opt.names, opt.tp)},
                      state_shapes=[tuple(t.shape) for t in opt.state.exp_avg],
                      masters={k: v.clone() for k, v in engine.master_params().items()})

    # ZeRO-Offload under TP: the host Adam over this rank's master shards,
    # stepped in 2 slices
    engine, batch = mlp_engine(spec, {"zero_optimization": {
        "stage": 2, "cpu_offload": True, "offload_stream_buckets": 2}})
    out["offload"] = [float(engine.train_step([batch])) for _ in range(4)]

    # bf16: the fp32 master is kept and split over the data group
    engine, batch = mlp_engine(spec, {"bf16": {"enabled": True}})
    engine.backward(engine(*(b.bfloat16() for b in batch)))
    engine.step()
    opt = engine.optimizer
    out["bf16"] = dict(dtype=str(next(engine.module.parameters()).dtype),
                       master_dtype=str(opt.master[0].dtype),
                       master_shapes=[tuple(m.shape) for m in opt.master],
                       param_shapes=[tuple(p.shape) for p in opt.params])

    # checkpoint round trip: save after 2 steps, resume in a fresh engine
    engine, batch = mlp_engine(spec)
    for _ in range(2):
        engine.train_step([batch])
    saved = {k: v.clone() for k, v in engine.master_params().items()}
    engine.save_checkpoint(ckpt_dir, tag="t")
    after = [float(engine.train_step([batch])) for _ in range(2)]
    want = {k: v.clone() for k, v in engine.master_params().items()}
    fresh, batch = mlp_engine(spec)
    fresh.load_checkpoint(ckpt_dir, tag="t")
    resumed = [float(fresh.train_step([batch])) for _ in range(2)]
    got = fresh.master_params()
    out["ckpt"] = dict(after=after, resumed=resumed, saved=saved,
                       equal=all(torch.equal(got[k], want[k]) for k in want),
                       state_equal=all(torch.equal(a, b) for a, b in
                                       zip(engine.optimizer.state.exp_avg,
                                           fresh.optimizer.state.exp_avg)))
    # tiny BERT at tensor_parallel 2 through initialize(), from JAX's
    # weights, without ZeRO and with ZeRO-2
    bert = spec["bert"]
    out["bert"] = {name: bert_engine_run(dict(bert, ds_config=dict(bert["ds_config"], **extra)),
                                         rank)
                   for name, extra in (("stage0", {"zero_optimization": {"stage": 0}}),
                                       ("stage2", {}))}
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_moe.py and tests/test_torch_onebit_adam.py
# ---------------------------------------------------------------------------

def moe_worker(rank, world, spec):
    from deepspeed_tpu_torch.parallel.expert import MoEConfig, MoELayer, expert_parallel_ffn

    group = torch.distributed.group.WORLD
    E = spec["params"]["w1"].shape[0]
    n = E // world
    params = {k: (_t(v) if k == "router" else _t(v)[rank * n:(rank + 1) * n])
              for k, v in spec["params"].items()}
    T = spec["x"].shape[0] // world
    x = _t(spec["x"])[rank * T:(rank + 1) * T]
    out, aux = expert_parallel_ffn(params, x, spec["capacity"], group)
    # the layer over the group: gradients reach the local experts
    cfg = MoEConfig(num_experts=E, d_model=x.shape[1], d_ff=params["w1"].shape[2])
    layer = MoELayer.from_jax_params(spec["params"], cfg).shard_experts(group)
    y, a = layer(x.reshape(1, T, -1))
    (y.sum() + a).backward()
    return dict(out=out, aux=float(aux), w1_grad_finite=bool(torch.isfinite(
        layer.w1.grad).all()), w1_local=tuple(layer.w1.shape))


def dense_grad_params(model):
    """BERT's parameters but the embedding tables, whose gradients are
    sparse: a row no token of the run touches keeps a zero variance, which
    the frozen-variance step divides by."""
    return [p for n, p in model.named_parameters()
            if not (n.startswith("bert.embeddings.") and "LayerNorm" not in n)]


def onebit_worker(rank, world, spec):
    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.runtime.fp16.onebit_adam import compressed_allreduce

    group = torch.distributed.group.WORLD
    c = spec["allreduce"]
    res, we, se = compressed_allreduce(_t(c["x"][rank]), _t(c["we"][rank]), _t(c["se"][rank]),
                                       group)
    out = dict(allreduce=(res, we, se))
    runs = {}
    for name, opt in (("onebit", {"type": "OneBitAdam",
                                  "params": {"lr": 1e-3, "freeze_step": spec["freeze"]}}),
                      ("adam", {"type": "Adam", "params": {"lr": 1e-3}})):
        cfg = dict(spec["ds_config"], optimizer=opt)
        model = dt.init_bert(spec["bert_cfg"], seed=0, device="cpu")
        engine, _, _, _ = dt.initialize(model=model, config=cfg, device="cpu",
                                        model_parameters=dense_grad_params(model))
        rows = spec["batch"][0].shape[0] // world
        batch = tuple(_t(b)[rank * rows:(rank + 1) * rows] for b in spec["batch"])
        losses = []
        for step in range(spec["steps"] if name == "onebit" else spec["freeze"]):
            losses.append(float(engine.train_step([batch])))
            if step + 1 == spec["freeze"]:
                warm = {k: v.clone() for k, v in engine.master_params().items()}
        runs[name] = dict(losses=losses, warm=warm, onebit=engine._onebit)
    out["runs"] = runs
    # the compressed phase on JAX's SimpleModel (Dense 16, relu, Dense 16,
    # MSE; fresh data every step), as its test_engine_onebit_compressed_converges:
    # freeze 3, lr 1e-2, 30 steps
    from deepspeed_tpu_torch.models.bert import _dense

    model = torch.nn.Sequential(torch.nn.Linear(16, 16), torch.nn.ReLU(),
                                torch.nn.Linear(16, 16))
    with torch.no_grad():
        _dense(model[0], spec["simple"]["Dense_0"])
        _dense(model[2], spec["simple"]["Dense_1"])
    engine, _, _, _ = dt.initialize(model=_MSE(model), config={
        "train_batch_size": 8, "optimizer": {"type": "OneBitAdam",
                                             "params": {"lr": 1e-2, "freeze_step": 3}}},
        device="cpu")
    xs, ys = _t(spec["simple_x"]), _t(spec["simple_y"])
    out["mlp"] = [float(engine.train_step([(xs[i, rank * 4:(rank + 1) * 4],
                                            ys[i, rank * 4:(rank + 1) * 4])]))
                  for i in range(xs.shape[0])]
    # the flat 1-bit step over elements that never see a gradient (an
    # embedding row no batch reads): the masters after every step
    from deepspeed_tpu_torch.runtime.fp16.onebit_adam import OnebitAdam

    sp = spec["sparse"]
    opt = OnebitAdam(lr=sp["lr"], freeze_step=sp["freeze"])
    flat = _t(sp["params"]).clone()
    state = opt.init_flat(flat.shape[0], world, "cpu")
    out["sparse"] = []
    for g in sp["grads"]:
        opt.update_flat(_t(g[rank]), state, flat, group)
        out["sparse"].append(flat.clone())
    return out


class _MSE(torch.nn.Module):
    def __init__(self, net):
        super().__init__()
        self.net = net

    def forward(self, x, y):
        return ((self.net(x) - y) ** 2).mean()


# ---------------------------------------------------------------------------
# tests/test_torch_serving_tp.py: the serving engine on a (1, world) mesh
# ---------------------------------------------------------------------------

def _serving_model(spec):
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHeadModel

    cfg = GPT2Config(**spec["model"])
    return GPT2LMHeadModel.from_jax_params(spec["params"], cfg).eval(), cfg


def serve_mesh(rank, spec, serving, clock_jump=None, passes=1, model_kw=None):
    """One engine on the mesh: rank 0 submits ``spec["prompts"]`` and drains,
    the others follow. ``clock_jump`` = (step, seconds) moves rank 0's clock
    forward after that step. Returns rank 0's tokens (or errors), every
    rank's per-step (step, timed_out, completed) record, the pool's local
    shape and bytes."""
    import time as _time

    from deepspeed_tpu_torch.inference.serving.config import ServingConfig
    from deepspeed_tpu_torch.inference.serving.engine import ServingEngine

    if model_kw is not None:
        from deepspeed_tpu_torch.models.gpt2 import GPT2Config, init_gpt2

        cfg = GPT2Config(**model_kw)
        model = init_gpt2(cfg, device="cpu")
    else:
        model, cfg = _serving_model(spec)
    if isinstance(serving, dict) and serving.get("from_config"):
        eng = ServingEngine.from_config(model, cfg, serving["from_config"], device="cpu")
    else:
        eng = ServingEngine(model, cfg, ServingConfig(**serving), device="cpu")
    steps = []
    offset = [0.0]
    real = _time.monotonic
    if clock_jump is not None and rank == 0:
        _time.monotonic = lambda: real() + offset[0]
    try:
        if rank == 0:
            futs = []
            for _ in range(passes):
                futs += [eng.submit(p, max_new_tokens=n, timeout_s=t)
                         for p, n, t in spec["requests"]]
                while eng.pending():
                    eng.step()
                    steps.append((eng._step_count, eng.scheduler.timed_out,
                                  eng.scheduler.completed))
                    if clock_jump is not None and eng._step_count == clock_jump[0]:
                        offset[0] = clock_jump[1]
            eng.close()
            tokens = []
            for f in futs:
                try:
                    tokens.append(f.result(timeout=0))
                except Exception as exc:  # noqa: BLE001 (reported to the test)
                    tokens.append(type(exc).__name__)
        else:
            with_submit = None
            try:
                eng.submit([1], max_new_tokens=1)
            except RuntimeError as exc:
                with_submit = str(exc)
            while eng.step() is not None:
                steps.append((eng._step_count, eng.scheduler.timed_out, eng.scheduler.completed))
            tokens = with_submit
    finally:
        _time.monotonic = real
    return dict(tokens=tokens, steps=steps, pool_shape=tuple(eng.pool.k.shape),
                pool_bytes=eng.pool.nbytes(), prefix=eng.prefix_stats(),
                layer_types=[type(m).__name__ for m in (eng.model.layers[0].qkv,
                                                        eng.model.layers[0].attn_out,
                                                        eng.model.layers[0].ff1,
                                                        eng.model.layers[0].ff2,
                                                        eng.model.wte)])


def serving_tp_worker(rank, world, spec):
    """Every case of ``spec["cases"]`` (name -> {"serving": config, and
    optionally "jump", "passes", "model"}) on the mesh, in one process
    group; a case whose engine refuses to build reports the error's type
    and text."""
    out = {}
    for name, case in spec["cases"].items():
        try:
            out[name] = serve_mesh(rank, dict(spec, requests=case.get("requests",
                                                                   spec["requests"])),
                                   case["serving"], clock_jump=case.get("jump"),
                                   passes=case.get("passes", 1),
                                   model_kw=case.get("model"))
        except Exception as exc:  # noqa: BLE001 (reported to the test)
            out[name] = {"error": f"{type(exc).__name__}: {exc}"}
            torch.distributed.barrier()
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_pipe_tp.py: ZeRO and tensor parallelism under the pipeline
# ---------------------------------------------------------------------------

PIPE_HIDDEN = 16


class PipeDense(torch.nn.Module):
    """``tests/unit/test_pipe.py``'s DenseLayer."""
    param_count = PIPE_HIDDEN * PIPE_HIDDEN

    def __init__(self):
        super().__init__()
        self.dense = torch.nn.Linear(PIPE_HIDDEN, PIPE_HIDDEN)

    def forward(self, x):
        return self.dense(x)

    @staticmethod
    def jax_state_dict(tree):
        p = tree["params"]["Dense_0"]
        return {"dense.weight": _t(np.asarray(p["kernel"]).T), "dense.bias": _t(p["bias"])}


class PipeRelu(torch.nn.Module):
    param_count = 0

    def forward(self, x):
        return torch.relu(x)


class TPBlock(torch.nn.Module):
    """``tests/unit/test_pipe.py``'s TPBlock: a residual MLP whose ff1 is
    column-parallel and ff2 row-parallel under tensor parallelism."""
    param_count = 8 * PIPE_HIDDEN * PIPE_HIDDEN

    def __init__(self):
        super().__init__()
        self.ff1 = torch.nn.Linear(PIPE_HIDDEN, 4 * PIPE_HIDDEN)
        self.ff2 = torch.nn.Linear(4 * PIPE_HIDDEN, PIPE_HIDDEN)

    def forward(self, x):
        return x + self.ff2(torch.relu(self.ff1(x)))

    @staticmethod
    def jax_state_dict(tree):
        p = tree["params"]
        return {f"{n}.{k}": _t(np.asarray(p[n][j]).T if j == "kernel" else p[n][j])
                for n in ("ff1", "ff2") for k, j in (("weight", "kernel"), ("bias", "bias"))}


def _pipe_mse(out, label):
    return torch.mean((out.float() - label.float()) ** 2)


def pipe_tp_run(rank, world, run, ckpt_dir=None):
    """One pipeline run of ``run`` (layers, init trees, config, data, tp, steps):
    rank ``rank``'s data part of every global micro-batch. Returns the losses,
    the whole masters, the names of the stage layers' types, and with
    ``ckpt_dir`` a tag saved after ``run["save_at"]`` steps, resumed in a
    fresh engine for the remaining steps."""
    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.parallel.mesh import MeshMpu, create_mesh
    from deepspeed_tpu_torch.runtime.pipe.module import LayerSpec, PipelineModule

    tp = run["tp"]
    dp = world // tp
    drank = rank // tp

    def engine():
        kinds = {"dense": PipeDense, "relu": PipeRelu, "tp": TPBlock}
        module = PipelineModule([LayerSpec(kinds[k]) for k in run["layers"]], num_stages=2,
                                loss_fn=_pipe_mse, partition_method="uniform")
        module.load_jax_params(run["init"])
        kw = {}
        if run.get("mpu"):
            kw["mpu"] = MeshMpu(create_mesh(model_parallel_size=tp))
        cfg = dict(run["config"])
        if tp > 1 and not run.get("mpu"):
            cfg["tensor_parallel"] = {"size": tp}
        eng, _, _, _ = dt.initialize(model=module, config_params=cfg, device="cpu", **kw)
        return eng

    def batches():
        rows = run["data"][0][0].shape[0] // dp
        return iter([(_t(x[drank * rows:(drank + 1) * rows]), _t(y[drank * rows:(drank + 1) * rows]))
                     for x, y in run["data"]])

    eng = engine()
    it = batches()
    out = {"types": sorted({type(m).__name__ for layer in eng.module.get_layers()
                            if isinstance(layer, torch.nn.Module) for m in layer.modules()})}
    steps = run["steps"]
    if ckpt_dir is None:
        out["losses"] = [eng.train_batch(it) for _ in range(steps)]
        out["masters"] = {k: v.clone() for k, v in eng.master_params().items()}
        return out
    first = [eng.train_batch(it) for _ in range(run["save_at"])]
    eng.save_checkpoint(ckpt_dir, tag="t")
    saved = {k: v.clone() for k, v in eng.master_params().items()}
    rest = [eng.train_batch(it) for _ in range(steps - run["save_at"])]
    fresh = engine()
    fresh.load_checkpoint(ckpt_dir, tag="t")
    loaded = {k: v.clone() for k, v in fresh.master_params().items()}
    it2 = batches()
    for _ in range(run["save_at"] * run["config"]["gradient_accumulation_steps"]):
        next(it2)
    resumed = [fresh.train_batch(it2) for _ in range(steps - run["save_at"])]
    out.update(losses=first + rest, saved=saved, loaded=loaded, resumed=resumed,
               masters={k: v.clone() for k, v in eng.master_params().items()},
               resumed_masters={k: v.clone() for k, v in fresh.master_params().items()})
    return out


def pipe_tp_worker(rank, world, spec, ckpt_dir):
    """Every run of ``spec`` in one process group."""
    return {name: pipe_tp_run(rank, world, run,
                              ckpt_dir=os.path.join(ckpt_dir, name) if run.get("save_at")
                              else None)
            for name, run in spec.items()}


# ---------------------------------------------------------------------------
# tests/test_torch_moe.py: an expert-parallel MoELayer under initialize()
# ---------------------------------------------------------------------------

class MoENet(torch.nn.Module):
    """``tests/unit/test_moe.py:115-120``'s model: Dense(8 -> d), MoELayer,
    Dense(d -> 4); MSE plus ``aux_weight`` times the aux loss. The weights
    come from the flax tree ``params`` (Dense_0, MoELayer_0, Dense_1)."""

    def __init__(self, params, experts=4, d=16, f=32, capacity_factor=1.25, aux_weight=0.01):
        from deepspeed_tpu_torch.parallel.expert import MoEConfig, MoELayer

        super().__init__()
        p = params["params"]
        self.inp = torch.nn.Linear(8, d)
        self.out = torch.nn.Linear(d, 4)
        for lin, name in ((self.inp, "Dense_0"), (self.out, "Dense_1")):
            with torch.no_grad():
                lin.weight.copy_(_t(np.asarray(p[name]["kernel"]).T))
                lin.bias.copy_(_t(p[name]["bias"]))
        self.moe = MoELayer.from_jax_params(
            p["MoELayer_0"], MoEConfig(num_experts=experts, d_model=d, d_ff=f,
                                       capacity_factor=capacity_factor))
        self.aux_weight = aux_weight

    def forward(self, x, y):
        h, aux = self.moe(self.inp(x))
        return ((self.out(h) - y) ** 2).mean() + self.aux_weight * aux


def moe_engine_run(spec, rank=0, world=1):
    """``spec["steps"]`` steps of ``MoENet`` through ``initialize()``: the
    experts split over the world when it has more than one rank, each rank
    on its rows of the global batch. Returns the losses and the whole
    masters."""
    import deepspeed_tpu_torch as dt

    model = MoENet(spec["params"], **spec.get("net", {}))
    if world > 1:
        model.moe.shard_experts(torch.distributed.group.WORLD)
    B = spec["x"].shape[0]
    rows = B // world
    x = _t(spec["x"])[rank * rows:(rank + 1) * rows]
    y = _t(spec["y"])[rank * rows:(rank + 1) * rows]
    engine, _, _, _ = dt.initialize(model=model, config={
        "train_batch_size": B, "train_micro_batch_size_per_gpu": rows,
        "optimizer": {"type": "Adam", "params": {"lr": 1e-2}}}, device="cpu")
    losses = []
    for _ in range(spec["steps"]):
        loss = engine(x, y)
        engine.backward(loss)
        engine.step()
        losses.append(float(loss))
    return dict(losses=losses, masters={k: v.clone() for k, v in engine.master_params().items()})


def moe_engine_worker(rank, world, spec):
    return moe_engine_run(spec, rank, world)
