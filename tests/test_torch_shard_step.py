"""The port's sharded (FSDP + TP) steps on gloo ranks against the port's
single-device step and the JAX package's sharded step, on the CPU.

``repro_torch.launch.steps``' train, prefill and serve steps on state made
DTensors by ``repro_torch.dist.sharding`` (``shard_params``,
``shard_opt_state``; the batch and cache by ``batch_specs`` and
``cache_specs``) over a "process" mesh of 4 gloo ranks (data 2 x model 2)
and of 8 (pod 2 x data 2 x model 2, the grad sync "xla" and
"seqbalance"), at REDUCED size: gemma2-2b, deepseek-moe-16b and recurrentgemma-9b (its
RG-LRU split over "model" on its channels) 2 train steps
(deepseek-moe-16b also at capacity factor 0.25, where each rank's rows drop
replicas), recurrentgemma-9b, deepseek-moe-16b on the pod mesh and
granite-moe-3b-a800m with 6 experts over 4 owners (padded to 8) a
prefill and one decode step, and so gemma2-2b with one KV head on both
meshes (the production condition: the KV heads do not split over
"model", so the cache's batch does, and decode attends there; the filled
cache moved by ``sharding.relayout``; its flash prefill each device's
query heads against their one KV head), gemma2-2b with three query heads
on one KV head on both meshes (the flash prefill split over the sequence,
two mirrored query blocks a "model" rank, through the windowed layers),
qwen3-32b with one KV head on (2, 2) (its qk-norm on the query heads split
over "model") and xlstm-1.3b at S = 512 on (2, 2) (its mLSTM prefill split
over the sequence, a 256-token chunk a "model" rank).  Each is held,
in float32, within ``chip_smoke.TRAIN_TOL`` (loss, nll, grad norm, lr,
each leaf's update) or ``compare.SERVE_TOL`` (the logits against each
row's RMS) against

  * the port's single-device step on the same weights and batches (on a
    pod mesh under "seqbalance", the "local" pod step of
    ``launch.steps``: the JAX package's pod step averages the pods' own
    losses and routes each pod's tokens alone), and
  * the JAX package's step jitted with the production rule's
    ``in_shardings`` on as many forced host devices (one subprocess runs
    every JAX case): under "xla" GSPMD's, which routes an MoE unit's
    tokens over the global batch, as the port's step does on a pod mesh
    (``moe.routed_over``).

Planted faults must fail the check: every rank taking the gradient of
model shard 0 for one leaf; deepseek-moe-16b on the pod mesh under "xla"
routing each pod's tokens alone; deepseek-moe-16b at capacity factor 0.25
with each rank cutting the capacity over its own rows.  All cases of a
mesh size run in one set of rank processes, started together with the JAX
subprocess.
"""
import json
import math
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from test_torch_collectives import ROOT, SRC  # noqa: E402  (puts the root on sys.path)
import chip_smoke  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.dist import collectives as coll, sharding  # noqa: E402
from repro_torch.launch import mesh as tmesh, steps as tsteps  # noqa: E402
from repro_torch.models import model, weights  # noqa: E402
from repro_torch.serve import compare  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from test_torch_models import configs  # noqa: E402

# name -> (arch, kind, mesh shape, grad sync)
CASES = {
    "gemma2-2b-2x2-xla": ("gemma2-2b", "train", (2, 2), "xla"),
    "gemma2-2b-2x2-planted": ("gemma2-2b", "train", (2, 2), "xla"),
    "deepseek-moe-16b-2x2-xla": ("deepseek-moe-16b", "train", (2, 2), "xla"),
    "recurrentgemma-9b-2x2-xla": ("recurrentgemma-9b", "train", (2, 2), "xla"),
    "recurrentgemma-9b-2x2-serve": ("recurrentgemma-9b", "serve", (2, 2), "xla"),
    "xlstm-1.3b-2x2-grads": ("xlstm-1.3b", "grads", (2, 2), "xla"),
    "gemma2-2b-2x2x2-xla": ("gemma2-2b", "train", (2, 2, 2), "xla"),
    "gemma2-2b-2x2x2-seqbalance": ("gemma2-2b", "train", (2, 2, 2), "seqbalance"),
    "deepseek-moe-16b-2x2x2-xla": ("deepseek-moe-16b", "train", (2, 2, 2), "xla"),
    "deepseek-moe-16b-2x2x2-pod-planted": ("deepseek-moe-16b", "train", (2, 2, 2), "xla"),
    "deepseek-moe-16b-2x2x2-seqbalance": ("deepseek-moe-16b", "train", (2, 2, 2), "seqbalance"),
    "recurrentgemma-9b-2x2x2-serve": ("recurrentgemma-9b", "serve", (2, 2, 2), "xla"),
    "deepseek-moe-16b-2x2x2-serve": ("deepseek-moe-16b", "serve", (2, 2, 2), "xla"),
    "deepseek-moe-16b@cf0.25-2x2-xla": ("deepseek-moe-16b@cf0.25", "train", (2, 2), "xla"),
    "deepseek-moe-16b@cf0.25-2x2-rank-capacity": ("deepseek-moe-16b@cf0.25", "train", (2, 2),
                                                  "xla"),
    "granite-moe-3b-a800m@6-experts-2x2x2-serve": ("granite-moe-3b-a800m@6-experts", "serve",
                                                   (2, 2, 2), "xla"),
    "deepseek-moe-16b-2x2-unit": ("deepseek-moe-16b", "unit", (2, 2), "xla"),
    "gemma2-2b@kv1-2x2-serve": ("gemma2-2b@kv1", "serve", (2, 2), "xla"),
    "gemma2-2b@kv1-2x2x2-serve": ("gemma2-2b@kv1", "serve", (2, 2, 2), "xla"),
    "xlstm-1.3b-2x2-serve512": ("xlstm-1.3b", "serve", (2, 2), "xla"),
    "gemma2-2b@seq-2x2-serve": ("gemma2-2b@seq", "serve", (2, 2), "xla"),
    "gemma2-2b@seq-2x2x2-serve": ("gemma2-2b@seq", "serve", (2, 2, 2), "xla"),
    "qwen3-32b@kv1-2x2-serve": ("qwen3-32b@kv1", "serve", (2, 2), "xla"),
}
# the REDUCED configurations changed for a case ("arch@variant" -> the
# fields replaced, "moe" the moe fields): a capacity factor at which the
# batch drops replicas on each rank; experts that do not split over the 4
# owners of a (2, 2, 2) mesh (pod x data: 6 padded to 8); one KV head, which
# does not split over "model", as gemma2-2b's 4 do not over 16 (the cache's
# batch then lies over "model", and decode attends there); three query
# heads on one KV head, none of which splits over "model" (the prefill's
# flash attention then splits the queries over the sequence, as gemma2-2b's
# 8 and 4 heads on 16); qwen3-32b's qk-norm with one KV head (the query
# heads split over "model", each device reading the one KV head)
VARIANTS = {"deepseek-moe-16b@cf0.25": {"moe": {"capacity_factor": 0.25}},
            "granite-moe-3b-a800m@6-experts": {"moe": {"n_experts": 6}},
            "gemma2-2b@kv1": {"n_kv_heads": 1},
            "gemma2-2b@seq": {"n_heads": 3, "n_kv_heads": 1},
            "qwen3-32b@kv1": {"n_kv_heads": 1}}
STEPS, BATCH, SEQ, SEED, CHUNKS, MAX_LEN = 2, 8, 16, 0, 2, 32
# a serve case's prompt length where it is not SEQ: xlstm-1.3b's mLSTM
# split over the sequence needs whole 256-token chunks on each "model" rank
SERVE_SEQ = {"xlstm-1.3b-2x2-serve512": 512}
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=8)
PLANTED_LEAF = "main.0.wq"  # its gradient's model shard 0 on every rank
# the planted cases -> their fault: every rank given model shard 0 of
# PLANTED_LEAF's gradient; each pod's MoE tokens routed alone; each rank
# cutting the MoE capacity over its own rows
PLANTED = {"gemma2-2b-2x2-planted": "model_shard",
           "deepseek-moe-16b-2x2x2-pod-planted": "pod_routing",
           "deepseek-moe-16b@cf0.25-2x2-rank-capacity": "rank_capacity"}
TRAIN_KEYS = ("loss", "grad_norm", "lr_ulps", "update_norm", "update_diff")


def case_configs(arch: str):
    """The JAX package's and the port's REDUCED config of a case's arch (an
    entry of VARIANTS: the arch's with its moe fields replaced)."""
    import dataclasses

    name, _, _ = arch.partition("@")
    jcfg, tcfg = configs(name)
    if arch in VARIANTS:
        jcfg, tcfg = (c.replace(**{k: dataclasses.replace(c.moe, **v) if k == "moe" else v
                                   for k, v in VARIANTS[arch].items()})
                      for c in (jcfg, tcfg))
    return jcfg, tcfg


def axes(shape) -> tuple:
    return tmesh.AXES[-len(shape):]


def data_cfg(mod, vocab: int):
    return mod.DataConfig(vocab=vocab, global_batch=BATCH, seq_len=SEQ, seed=SEED)


def serve_inputs(cfg, seq: int = SEQ) -> tuple:
    """The prompt batch of ``seq`` tokens and the decode step's tokens."""
    rng = np.random.default_rng(SEED)
    tokens = rng.integers(0, cfg.vocab, (BATCH, seq)).astype(np.int32)
    return {"tokens": tokens}, rng.integers(0, cfg.vocab, (BATCH, 1)).astype(np.int32)


# ----------------------------------------------------------------- the port
def drop_model_shard(orig):
    """Planted fault: ``optimizer._grad`` with every rank given model shard
    0's block of PLANTED_LEAF's gradient."""
    from torch.distributed.tensor import DTensor, Replicate

    def grad(grads, name, i, p):
        g = orig(grads, name, i, p)
        if name != PLANTED_LEAF:
            return g
        mesh = p.device_mesh
        d = mesh.mesh_dim_names.index("model")
        pl = p.placements[d]
        assert pl.is_shard(), p.placements
        rep = list(p.placements)
        rep[d] = Replicate()
        whole = g.redistribute(mesh, rep).to_local()
        block = whole.narrow(pl.dim, 0, whole.shape[pl.dim] // mesh.size(d)).contiguous()
        return DTensor.from_local(block, mesh, p.placements, run_check=False)

    return grad


def full_params(params) -> dict:
    """leaf name -> the whole master as numpy (stacked), from DTensors or
    plain tensors (a collective on every rank for DTensors)."""
    return weights.stacked(
        (n, i, (t.full_tensor() if hasattr(t, "full_tensor") else t).detach().numpy().copy())
        for n, i, t in weights.leaves(params))


def port_train(arch: str, mesh=None, grad_sync: str = "xla", planted: str | None = None) -> dict:
    """STEPS steps of the port's train step from ``numpy_params``: sharded
    over ``mesh`` (a "process" mesh of this gloo group), on one device
    (``mesh`` None), or over a "local" pod mesh; the metrics and the
    params after the last.  ``planted``: a fault of ``PLANTED``'s."""
    import contextlib

    from repro_torch.models import moe

    _, tcfg = case_configs(arch)
    params = weights.from_jax_params(weights.numpy_params(tcfg, SEED), tcfg, "cpu",
                                     trainable=True)
    state = {"params": params, "opt": topt.init(params)}
    if mesh is not None and mesh.transport == "process":
        sharding.shard_params(params, tcfg, mesh)
        state["opt"] = sharding.shard_opt_state(state["opt"], tcfg, mesh)
    step = tsteps.make_train_step(tcfg, topt.AdamWConfig(**OPT), mesh, grad_sync,
                                  coll.PathPlan(n_chunks=CHUNKS))
    orig, routed_over, route_rank = topt._grad, moe.routed_over, moe.route_rank
    if planted == "model_shard":
        topt._grad = drop_model_shard(orig)
    elif planted == "pod_routing":
        moe.routed_over = lambda group: contextlib.nullcontext()
    elif planted == "rank_capacity":  # each rank cuts the capacity over its own rows
        moe.route_rank = lambda logits, before, T, cfg, experts=None: route_rank(
            logits, None, logits.shape[0], cfg, experts)
    rows = []
    try:
        for i in range(STEPS):
            batch = tpipe.batch_at(data_cfg(tpipe, tcfg.vocab), i, device="cpu")
            state, m = step(state, batch)
            rows.append({k: float(v) for k, v in m.items()})
    finally:
        topt._grad, moe.routed_over, moe.route_rank = orig, routed_over, route_rank
    return {"rows": rows, "params": full_params(state["params"])}


def port_serve(arch: str, mesh=None, seq: int = SEQ) -> dict:
    """The prefill's last logits of ``seq`` tokens and one decode step's,
    from the frozen ``numpy_params`` (sharded over ``mesh`` if given)."""
    _, tcfg = case_configs(arch)
    params = weights.from_jax_params(weights.numpy_params(tcfg, SEED), tcfg, "cpu")
    if mesh is not None:
        sharding.shard_params(params, tcfg, mesh)
    batch, tok = serve_inputs(tcfg, seq)
    logits, cache = tsteps.make_prefill_step(tcfg, max(MAX_LEN, seq + 1))(
        params, {k: torch.from_numpy(v) for k, v in batch.items()})
    _, dlogits, _ = tsteps.make_serve_step(tcfg)(params, torch.from_numpy(tok), cache)

    def whole(t):
        return (t.full_tensor() if hasattr(t, "full_tensor") else t).detach().numpy()

    return {"prefill": whole(logits), "decode": whole(dlogits)}


def port_grads(arch: str, mesh=None) -> dict:
    """One forward and backward of the loss from ``numpy_params`` (sharded
    over ``mesh`` if given): each leaf's whole gradient (stacked)."""
    from torch.distributed.tensor.experimental import implicit_replication

    _, tcfg = case_configs(arch)
    params = weights.from_jax_params(weights.numpy_params(tcfg, SEED), tcfg, "cpu",
                                     trainable=True)
    batch = tpipe.batch_at(data_cfg(tpipe, tcfg.vocab), 0, device="cpu")
    if mesh is not None:
        sharding.shard_params(params, tcfg, mesh)
        batch = sharding.shard_batch(batch, mesh)
    with implicit_replication():
        loss, _ = model.loss_fn(params, tcfg, batch)
        loss.backward()
    return weights.stacked(
        (n, i, (t.grad.full_tensor() if hasattr(t.grad, "full_tensor") else t.grad).numpy())
        for n, i, t in weights.leaves(params))


def port_unit(arch: str, mesh=None) -> dict:
    """The MoE unit of ``numpy_params``' first superblock alone (float32
    masters) on x [3, 5, D]: 15 tokens, which do not split over the 2 data
    ranks of a (2, 2) mesh, so each rank routes them all and the combine
    is summed over the experts' owners.  Its output, its aux losses, and
    the gradients of x and of each weight of sum(out * g) plus the aux
    losses (sharded over ``mesh`` if given)."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.models import common, moe, transformer

    _, tcfg = case_configs(arch)
    fields = {k: v[0] for k, v in weights.numpy_params(tcfg, SEED)["main"][1].items()}
    p = transformer.unit_params(tcfg, transformer.Unit("moe"), fields, torch.float32,
                                master=torch.float32)
    rng = np.random.default_rng(SEED)
    x, g = (torch.as_tensor(rng.standard_normal((3, 5, tcfg.d_model), dtype=np.float32))
            for _ in range(2))
    x.requires_grad_(True)
    xs = x
    if mesh is not None:
        specs = sharding.param_specs(tcfg, mesh)
        for f in moe.MoEParams.FIELDS:
            spec = sharding.port_spec(f"main.1.{f}", specs[f"main.1.{f}"])
            p._parameters[f] = torch.nn.Parameter(sharding.distribute(p._parameters[f], mesh,
                                                                      spec))
        dm = mesh.to_device_mesh()
        xs = common.batch_layout(DTensor.from_local(x, dm, [Replicate()] * dm.ndim,
                                                    run_check=False))
    with implicit_replication():
        out, aux = moe.apply(p, xs, tcfg)
        (torch.sum(out * g) + aux["lb_loss"] + aux["z_loss"]).backward()

    def whole(t):
        return (t.full_tensor() if hasattr(t, "full_tensor") else t).detach().numpy()

    return {"out": whole(out), "lb_loss": whole(aux["lb_loss"]),
            "z_loss": whole(aux["z_loss"]), "grad_x": x.grad.numpy(),
            **{f"grad_{f}": whole(p._parameters[f].grad) for f in moe.MoEParams.FIELDS}}


def rank_runs(world: int) -> dict:
    """Every case of ``world`` ranks on this gloo group: arrays by
    "case/key" (the metrics as JSON)."""
    out = {}
    for name, (arch, kind, shape, grad_sync) in CASES.items():
        if math.prod(shape) != world:
            continue
        t0 = time.time()
        mesh = tmesh.make_mesh_like(shape)
        assert mesh.transport == "process"
        if kind == "train":
            run = port_train(arch, mesh, grad_sync, planted=PLANTED.get(name))
            out[f"{name}/rows"] = np.array(json.dumps(run["rows"]))
            out.update({f"{name}/p/{k}": v for k, v in run["params"].items()})
        elif kind == "grads":
            out.update({f"{name}/p/{k}": v for k, v in port_grads(arch, mesh).items()})
        elif kind == "unit":
            out.update({f"{name}/{k}": v for k, v in port_unit(arch, mesh).items()})
        else:
            out.update({f"{name}/{k}": v
                        for k, v in port_serve(arch, mesh, SERVE_SEQ.get(name, SEQ)).items()})
        out[f"{name}/wall"] = np.array(time.time() - t0)
    return out


RANKS = """
    init()
    import test_torch_shard_step as t
    out = t.rank_runs(WORLD)
    np.savez(OUT, **(out if RANK == 0 else {}))
    dist.destroy_process_group()
"""


def pod_routed(arch: str, shape, grad_sync: str) -> bool:
    """Whether the case's step is the JAX package's pod step (manual over
    "pod"): "seqbalance" on a pod mesh.  Under "xla" the JAX package
    leaves the pod axis to GSPMD, which routes an MoE unit's tokens over
    the global batch, and so does the port's step."""
    return "pod" in axes(shape) and grad_sync == "seqbalance"


# ----------------------------------------------------------- the JAX package
def jax_mesh(shape):
    """The JAX mesh of a case's shape, a (pod, data, model) one as (pod x
    data, model): under jax 0.9.0 the JAX package's steps on a mesh of
    three axes of forced host devices disagree with its own one-device
    step (REDUCED gemma2-2b's first grad norm 1.868 where one device and
    the (2, 2) and (1, 8) meshes give 2.025; recurrentgemma-9b's decode
    logits 0.28 off), and the pod axis of these steps is data parallelism
    alone, so merged into "data" it leaves the function as it is."""
    if len(shape) == 3:
        shape = (shape[0] * shape[1], shape[2])
    devs = np.array(jax.devices()[:math.prod(shape)]).reshape(shape)
    return jax.sharding.Mesh(devs, axes(shape))


def jax_named(tree, mesh):
    from jax.sharding import NamedSharding, PartitionSpec as P

    return jax.tree.map(lambda s: NamedSharding(mesh, s), tree,
                        is_leaf=lambda x: isinstance(x, P))


def jax_train(arch: str, shape, grad_sync: str) -> dict:
    """The JAX package's train step jitted with the production rule's
    ``in_shardings`` (``repro.launch.dryrun``'s); its pod step where the
    port's step is one (``pod_routed``)."""
    from jax.sharding import PartitionSpec as P

    from repro.data import pipeline as jpipe
    from repro.dist import collectives as jcoll, sharding as jshard
    from repro.launch import steps as jsteps
    from repro.train import optimizer as jopt
    from test_torch_models import to_jax
    from test_torch_train import leaf_dict

    jcfg, tcfg = case_configs(arch)
    jp = to_jax(weights.numpy_params(tcfg, SEED), jcfg)
    state = {"params": jp, "opt": jopt.init(jp)}
    if pod_routed(arch, shape, grad_sync):
        # the partial-manual shard_map over a (pod, data, model) mesh aborts
        # XLA's SPMD partitioner under jax 0.9; over a 1-D pod mesh the same
        # step (manual over "pod"; the auto axes do not change its values)
        from repro.launch import mesh as jmesh

        step = jax.jit(jsteps.make_train_step(jcfg, jopt.AdamWConfig(**OPT),
                                              jmesh.make_pod_mesh(shape[0]), "seqbalance",
                                              jcoll.PathPlan(n_chunks=CHUNKS)))
        rows = []
        for i in range(STEPS):
            state, m = step(state, jpipe.batch_at(data_cfg(jpipe, jcfg.vocab), i))
            rows.append({k: float(v) for k, v in m.items()})
        return {"rows": rows, "params": leaf_dict(state["params"])}
    mesh = jax_mesh(shape)
    specs = {"params": jshard.param_specs(jp, mesh),
             "opt": jopt.AdamWState(step=P(), mu=jshard.param_specs(state["opt"].mu, mesh),
                                    nu=jshard.param_specs(state["opt"].nu, mesh))}
    batch0 = jpipe.batch_at(data_cfg(jpipe, jcfg.vocab), 0)
    step = jax.jit(jsteps.make_train_step(jcfg, jopt.AdamWConfig(**OPT), mesh, grad_sync),
                   in_shardings=(jax_named(specs, mesh),
                                 jax_named(jshard.batch_specs(batch0, mesh), mesh)),
                   out_shardings=(jax_named(specs, mesh), None))
    rows = []
    with mesh:
        for i in range(STEPS):
            state, m = step(state, jpipe.batch_at(data_cfg(jpipe, jcfg.vocab), i))
            rows.append({k: float(v) for k, v in m.items()})
    return {"rows": rows, "params": leaf_dict(state["params"])}


def jax_serve(arch: str, shape, seq: int = SEQ) -> dict:
    """The JAX package's prefill of ``seq`` tokens and serve step jitted with
    the production rule's shardings (the dry run's)."""
    import jax.numpy as jnp

    from repro.dist import sharding as jshard
    from repro.launch import steps as jsteps
    from test_torch_models import to_jax

    jcfg, tcfg = case_configs(arch)
    jp = to_jax(weights.numpy_params(tcfg, SEED), jcfg)
    mesh = jax_mesh(shape)
    batch, tok = serve_inputs(tcfg, seq)
    batch = {k: jnp.asarray(v) for k, v in batch.items()}
    pf = jsteps.make_prefill_step(jcfg, max(MAX_LEN, seq + 1))
    c_specs = jshard.cache_specs(jax.eval_shape(pf, jp, batch)[1], mesh)
    pspecs = jax_named(jshard.param_specs(jp, mesh), mesh)
    prefill = jax.jit(pf, in_shardings=(pspecs, jax_named(jshard.batch_specs(batch, mesh),
                                                          mesh)),
                      out_shardings=(None, jax_named(c_specs, mesh)))
    tok = jnp.asarray(tok)
    serve = jax.jit(jsteps.make_serve_step(jcfg),
                    in_shardings=(pspecs, jax_named(jshard.batch_specs({"t": tok}, mesh)["t"],
                                                    mesh), jax_named(c_specs, mesh)))
    with mesh:
        logits, cache = prefill(jp, batch)
        _, dlogits, _ = serve(jp, tok, cache)
    return {"prefill": np.asarray(logits), "decode": np.asarray(dlogits)}


JAX_RUNS = textwrap.dedent("""
    import json, sys, time
    import numpy as np
    import jax
    sys.path.insert(0, sys.argv[2])
    import test_torch_shard_step as t

    out, rows, t0 = {}, {}, time.time()
    for name, (arch, kind, shape, grad_sync) in t.CASES.items():
        if name in t.PLANTED or kind in ("grads", "unit"):
            continue
        if kind == "train":
            run = t.jax_train(arch, shape, grad_sync)
            rows[name] = run["rows"]
            out.update({f"{name}/p/{k}": v for k, v in run["params"].items()})
        else:
            out.update({f"{name}/{k}": v for k, v in
                        t.jax_serve(arch, shape, t.SERVE_SEQ.get(name, t.SEQ)).items()})
    np.savez(sys.argv[1], **out)
    print(json.dumps({"devices": jax.device_count(), "rows": rows, "wall": time.time() - t0}))
""")


def split(arrays: dict) -> dict:
    """"case/key" arrays -> case -> {"rows", "params", or the serve keys}."""
    out = {}
    for key, v in arrays.items():
        name, rest = key.split("/", 1)
        case = out.setdefault(name, {})
        if rest == "rows":
            case["rows"] = json.loads(str(v))
        elif rest.startswith("p/"):
            case.setdefault("params", {})[rest[2:]] = v
        else:
            case[rest] = v
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The gloo groups of 4 and 8 ranks and the JAX subprocess, all started
    at once."""
    tmp = tmp_path_factory.mktemp("shard_step")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(SRC), str(ROOT / "tests")]),
               OMP_NUM_THREADS="1")
    jax_out = tmp / "jax.npz"
    jproc = subprocess.Popen([sys.executable, "-c", JAX_RUNS, str(jax_out), str(ROOT / "tests")],
                             env=dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=8",
                                      JAX_PLATFORMS="cpu"),
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    groups = {world: start_ranks(RANKS, world, tmp, env) for world in (4, 8)}
    port = {}
    for world, procs in groups.items():
        port.update(split(finish_ranks(procs)))
    out, err = jproc.communicate(timeout=600)
    assert jproc.returncode == 0, err[-3000:]
    res = json.loads(out.strip().splitlines()[-1])
    assert res["devices"] == 8
    print({"jax_wall": res["wall"], **{n: float(c["wall"]) for n, c in port.items()}})
    want = split(dict(np.load(jax_out)))
    for name, rows in res["rows"].items():
        want[name]["rows"] = rows
    return {"port": port, "jax": want}


def start_ranks(code: str, world: int, tmp, env) -> list:
    """``code`` in ``world`` processes at once, each a rank of a gloo group
    (``test_torch_collectives.run_ranks``' prelude), without waiting."""
    init = tmp / f"rendezvous_{world}"
    prelude = textwrap.dedent(f"""
        import os, sys
        import numpy as np
        import torch
        import torch.distributed as dist
        RANK, WORLD = int(sys.argv[1]), {world}
        OUT = sys.argv[2]

        def init():
            dist.init_process_group("gloo", init_method="file://{init}", rank=RANK,
                                    world_size=WORLD)
    """)
    outs = [tmp / f"rank{world}_{r}.npz" for r in range(world)]
    return [(subprocess.Popen([sys.executable, "-c", prelude + textwrap.dedent(code), str(r),
                               str(outs[r])], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True), outs[r])
            for r in range(world)]


def finish_ranks(procs: list) -> dict:
    """Rank 0's arrays once every rank has ended well."""
    errs = []
    for p, _ in procs:
        try:
            _, err = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q, _ in procs:
                q.kill()
            raise
        errs.append(err)
    assert all(p.returncode == 0 for p, _ in procs), [e[-2000:] for e in errs]
    return dict(np.load(procs[0][1]))


# --------------------------------------------------------------- the checks
def agreement(got: dict, want: dict, p0: dict) -> dict:
    """``chip_smoke.TRAIN_TOL``'s readings of a run against another: the
    largest relative error of the loss and the grad norm over the steps,
    the lr in ulps, and over the leaves the relative error of the update
    p_n - p_0's norm ("update_norm") and of the update itself, all of its
    entries ("update_diff")."""
    def rel(a, b):
        return abs(a - b) / max(abs(b), 1e-30)

    rows = list(zip(got["rows"], want["rows"]))
    out = {k: max(rel(g[k], w[k]) for g, w in rows) for k in ("loss", "grad_norm")}
    out["lr_ulps"] = max(chip_smoke.ulps(g["lr"], w["lr"]) for g, w in rows)
    norm, diff = [], []
    for k, w0 in p0.items():
        dg = got["params"][k].astype(np.float64) - w0
        dw = want["params"][k].astype(np.float64) - w0
        nw = np.linalg.norm(dw)
        if nw:
            norm.append(rel(np.linalg.norm(dg), nw))
            diff.append(np.linalg.norm(dg - dw) / nw)
    out["update_norm"], out["update_diff"] = max(norm), max(diff)
    return out


def train_within(err: dict) -> bool:
    return all(err[k] <= chip_smoke.TRAIN_TOL[k] for k in TRAIN_KEYS)


def serve_error(got: dict, want: dict) -> float:
    """The largest |logit error| over each row's RMS, prefill and decode."""
    out = 0.0
    for key in ("prefill", "decode"):
        g, w = np.asarray(got[key], np.float64), np.asarray(want[key], np.float64)
        rms = np.sqrt(np.mean(w ** 2, axis=-1, keepdims=True))
        out = max(out, float(np.max(np.abs(g - w) / rms)))
    return out


def p0_of(arch: str) -> dict:
    _, tcfg = case_configs(arch)
    return {k: np.asarray(v) for k, v in full_params(weights.from_jax_params(
        weights.numpy_params(tcfg, SEED), tcfg, "cpu")).items()}


def single_device(name: str) -> dict:
    """The port's one-device reference of a case: the single-device step
    over the global batch, or on a pod mesh under "seqbalance" the "local"
    pod step (each pod's loss and routing its own, the means through the
    ring on the float32 wire)."""
    arch, kind, shape, grad_sync = CASES[name]
    if kind == "serve":  # one thread: the recurrences' small steps gain nothing from more
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            return port_serve(arch, seq=SERVE_SEQ.get(name, SEQ))
        finally:
            torch.set_num_threads(threads)
    if pod_routed(arch, shape, grad_sync):
        return port_train(arch, tmesh.make_pod_mesh(shape[0], device="cpu"), "seqbalance")
    return port_train(arch)


@pytest.mark.parametrize("name", [n for n, c in CASES.items()
                                  if n not in PLANTED and c[1] in ("train", "serve")])
def test_sharded_step_matches_one_device_and_the_jax_sharded_step(runs, name):
    arch, kind, shape, grad_sync = CASES[name]
    got, ref, want = runs["port"][name], single_device(name), runs["jax"][name]
    if kind == "serve":
        err = {"one_device": serve_error(got, ref), "jax": serve_error(got, want)}
        print(name, err)
        assert max(err.values()) <= compare.SERVE_TOL["float32"], err
        return
    p0 = p0_of(arch)
    err = {"one_device": agreement(got, ref, p0), "jax": agreement(got, want, p0)}
    print(name, err)
    assert train_within(err["one_device"]) and train_within(err["jax"]), err


def test_slstm_rows_give_the_one_device_gradients(runs):
    """xlstm-1.3b's sLSTM loop runs each device's own rows
    (``common.on_rows``), its recurrent weights' gradient a partial sum over
    them: every leaf's gradient within TRAIN_TOL's leaf-norm limit of the
    one-device gradient (AdamW's first steps turn such differences into
    sign flips of small entries, so the updates are not compared)."""
    got, want = runs["port"]["xlstm-1.3b-2x2-grads"]["params"], port_grads("xlstm-1.3b")
    assert set(got) == set(want)
    err = {k: float(np.linalg.norm(got[k] - want[k]) / max(np.linalg.norm(want[k]), 1e-30))
           for k in want}
    worst = max(err, key=err.get)
    print(worst, err[worst])
    assert err[worst] <= chip_smoke.TRAIN_TOL["leaf_grad_norm"], (worst, err[worst])


def test_moe_unit_on_rows_that_do_not_split_gives_the_one_device_unit(runs):
    """deepseek-moe-16b's MoE unit alone on 15 tokens over the (2, 2) mesh
    (``port_unit``: the rows replicated over "data", each data rank
    owning half the experts and the combine summed over them): the
    output, the aux losses and every gradient within TRAIN_TOL's
    leaf-norm limit of the one-device unit."""
    got, want = runs["port"]["deepseek-moe-16b-2x2-unit"], port_unit("deepseek-moe-16b")
    assert set(got) - {"wall"} == set(want)
    err = {k: float(np.linalg.norm(got[k] - want[k]) / max(np.linalg.norm(want[k]), 1e-30))
           for k in want}
    print(err)
    assert max(err.values()) <= chip_smoke.TRAIN_TOL["leaf_grad_norm"], err


def test_planted_model_shard_fault_fails_the_check(runs):
    """Every rank taking model shard 0's block of one leaf's gradient moves
    that leaf off both references."""
    got = runs["port"]["gemma2-2b-2x2-planted"]
    p0 = p0_of("gemma2-2b")
    err = agreement(got, runs["jax"]["gemma2-2b-2x2-xla"], p0)
    print(err)
    assert not train_within(err), err
    clean = agreement(runs["port"]["gemma2-2b-2x2-xla"], runs["jax"]["gemma2-2b-2x2-xla"], p0)
    assert train_within(clean), clean


def test_planted_pod_by_pod_routing_fails_the_check(runs):
    """deepseek-moe-16b on the (2, 2, 2) mesh under "xla" with each pod's
    tokens routed alone (the capacity cut over a pod's 64 tokens, the aux
    losses of a pod's routing): off the JAX package's GSPMD step, which the
    step routing every pod's tokens as one batch holds."""
    name = "deepseek-moe-16b-2x2x2-xla"
    p0, want = p0_of("deepseek-moe-16b"), runs["jax"][name]
    err = agreement(runs["port"]["deepseek-moe-16b-2x2x2-pod-planted"], want, p0)
    print(err)
    assert not train_within(err), err
    clean = agreement(runs["port"][name], want, p0)
    assert train_within(clean), clean


def test_planted_rank_local_capacity_fails_the_check(runs):
    """deepseek-moe-16b at capacity factor 0.25 on the (2, 2) mesh, whose
    batch drops replicas in every MoE layer on each data rank's rows: with
    each rank cutting the capacity over its own rows (``moe.route_rank``
    given no replicas before it and its own T), off the JAX package's
    GSPMD step, which the clean case holds."""
    arch, name = "deepseek-moe-16b@cf0.25", "deepseek-moe-16b@cf0.25-2x2-xla"
    _, tcfg = case_configs(arch)
    params = weights.from_jax_params(weights.numpy_params(tcfg, SEED), tcfg, "cpu")
    routes = []
    with torch.no_grad():
        model.forward_train(params, tcfg, tpipe.batch_at(data_cfg(tpipe, tcfg.vocab), 0,
                                                         device="cpu"), routes=routes)
    for r in routes:  # each data rank's rows drop replicas
        assert all(bool((rows == r.sentinel).any()) for rows in r.slot.chunk(2)), r.dropped
    p0, want = p0_of(arch), runs["jax"][name]
    err = agreement(runs["port"]["deepseek-moe-16b@cf0.25-2x2-rank-capacity"], want, p0)
    print(err)
    assert not train_within(err), err
    clean = agreement(runs["port"][name], want, p0)
    assert train_within(clean), clean


def test_sharded_state_is_made_of_dtensors_with_the_rule_s_placements():
    """``shard_params``/``shard_opt_state`` on a fake (2, 2, 2) group: every
    master and moment a DTensor with ``placements(port_spec(...))``, the
    moments stacked, each local shard the block of rank 0."""
    from torch.distributed.tensor import DTensor

    _, tcfg = configs("gemma2-2b")
    mesh = tmesh.fake_mesh((2, 2, 2))
    try:
        params = weights.from_jax_params(weights.numpy_params(tcfg, SEED), tcfg, "cpu",
                                         trainable=True)
        opt = topt.init(params)
        whole = {n: t.detach().clone() for n, _, t in weights.leaves(params)}
        sharding.shard_params(params, tcfg, mesh)
        opt = sharding.shard_opt_state(opt, tcfg, mesh)
        specs, shapes = sharding.param_specs(tcfg, mesh), sharding.param_shapes(tcfg)
        for name, i, t in weights.leaves(params):
            want = sharding.placements(sharding.port_spec(name, specs[name]), mesh)
            assert isinstance(t, DTensor) and tuple(t.placements) == want, name
            assert t.requires_grad
            local = whole[name]
            for d, pl in enumerate(t.placements):
                if pl.is_shard():
                    local = local.narrow(pl.dim, 0, local.shape[pl.dim] // 2)
            if i is None:
                torch.testing.assert_close(t.to_local(), local, rtol=0, atol=0)
            mu = opt.mu[name]
            assert isinstance(mu, DTensor) and tuple(mu.shape) == shapes[name], name
            assert mu.to_local().shape[1 if i is not None else 0:] == local.shape, name
    finally:
        torch.distributed.destroy_process_group()
