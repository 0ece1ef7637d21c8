"""Step builders: train_step / prefill_step / serve_step for any
architecture, mirroring ``repro.launch.steps``.

Two grad-sync modes, as in the JAX package:

  * "xla": one device; the loss and its gradients (autograd over
    ``model.loss_fn``, the plain attention and ``cfg.remat``), then
    ``optimizer.update`` on the float32 masters in place.  The mesh, if
    any, is not read.
  * "seqbalance" on a mesh with a ``pod`` axis of more than one member:
    each member takes its share of the global batch (dim 0 split over the
    pod axis, the JAX package's ``in_specs=P("pod")``), its loss and
    gradients; then ``dist.collectives.tree_all_reduce_mean`` over the pod
    axis with the plan (one ring a chunk, in its path's direction), the
    loss averaged through ``baseline_all_reduce``, and ``optimizer.update``
    on the mean gradients.  On a "process" mesh each rank runs its own
    share on its own state.  On a "local" mesh the members run one after
    another on one device and write their gradients into one [n, ...]
    buffer a leaf (the JAX layout's, stacked leaves stacked).  On the
    float32 wire every member ends with the same mean, bit for bit, so one
    state is stepped; on a lossy wire a segment's owner keeps its exact sum
    and the others their decoded copy, so, as the JAX package's devices
    each step their own copy of the replicated state, each member steps
    its own (member 0's is the caller's, the others copies of it), and the
    step returns member 0's, as the JAX package reads device 0's.
"""
from __future__ import annotations

import copy
import weakref

import torch

from repro_torch.dist import collectives, sharding
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import common, model, moe, weights
from repro_torch.train import optimizer as opt_mod


def _share(batch: dict, n: int, m: int) -> dict:
    """Member ``m``'s rows of a global batch split over ``n`` members."""
    B = next(iter(batch.values())).shape[0]
    if B % n:
        raise ValueError(f"a global batch of {B} does not split over {n} pods")
    b = B // n
    return {k: v[m * b:(m + 1) * b] for k, v in batch.items()}


def _sync(grads: dict, axis, plan) -> dict:
    """``tree_all_reduce_mean`` a leaf at a time, each input released as its
    mean is made (two copies of every gradient would not fit beside a
    published model's state)."""
    return {name: collectives.tree_all_reduce_mean(grads.pop(name), axis, plan)
            for name in list(grads)}


def _pod_train_step(cfg, opt_cfg, mesh, plan):
    axis = mesh.axis("pod")
    n = axis.size
    local = isinstance(axis, collectives.LocalAxis)
    # on a lossy wire the members end a step with their own roundings of
    # the mean (a segment's owner keeps its exact sum), and in the JAX
    # package each device then steps its own copy of the state
    replicas = local and (plan or collectives.PathPlan()).wire_dtype != "float32"
    held = {}

    def member_states(state) -> list:
        """The state each local member steps: the caller's alone, or with a
        lossy wire the caller's (member 0's) and n - 1 copies made from it
        (anew when the caller passes another state, say a restored one)."""
        if not replicas:
            return [state]
        if held.get("of") is not state["params"]:
            held["of"] = state["params"]
            held["states"] = [state] + [copy.deepcopy(state) for _ in range(n - 1)]
        return held["states"]

    def backward(params, batch):
        loss, metrics = model.loss_fn(params, cfg, batch)
        loss.backward()
        return loss.detach(), metrics["nll"].detach()

    def local_grads(states, batch):
        params0 = states[0]["params"]
        if params0.device != axis.device:
            raise ValueError(f"params on {params0.device} for a pod mesh on {axis.device}")
        bufs = {name: torch.zeros((n, *shape), dtype=torch.float32, device=params0.device)
                for name, shape in sharding.param_shapes(cfg).items()}
        losses, nlls = [], []
        for m in range(n):
            params = states[m % len(states)]["params"]
            slots = [(p, bufs[name][m] if i is None else bufs[name][m, i])
                     for name, i, p in weights.leaves(params)]
            for p, slot in slots:  # autograd adds each gradient into its slot in place
                p.grad = slot
            loss, nll = backward(params, _share(batch, n, m))
            for p, slot in slots:
                if p.grad.data_ptr() != slot.data_ptr():
                    slot.copy_(p.grad)
                p.grad = None
            losses.append(loss)
            nlls.append(nll)
        del slots  # its views would keep every buffer alive through the sync
        return torch.stack(losses), torch.stack(nlls), _sync(bufs, axis, plan)

    def process_grads(states, batch):
        params = states[0]["params"]
        for p in params.parameters():
            p.grad = None
        loss, nll = backward(params, _share(batch, n, axis.rank))
        grads = weights.stacked((name, i, torch.zeros_like(p) if p.grad is None else p.grad)
                                for name, i, p in weights.leaves(params))
        for p in params.parameters():
            p.grad = None
        return loss, nll, _sync(grads, axis, plan)

    def train_step(state, batch):
        states = member_states(state)
        loss, nll, grads = (local_grads if local else process_grads)(states, batch)
        loss = collectives.baseline_all_reduce(loss, axis) / n
        nll = collectives.baseline_all_reduce(nll, axis) / n
        if local:  # each member's own mean (and loss, the same on every member)
            loss, nll = loss[0], nll[0]
            for m in reversed(range(len(states))):
                _, opt, om = opt_mod.update({k: g[m] for k, g in grads.items()},
                                            states[m]["opt"], states[m]["params"], opt_cfg)
                states[m]["opt"] = opt
        else:
            _, opt, om = opt_mod.update(grads, state["opt"], state["params"], opt_cfg)
        return {"params": state["params"], "opt": opt}, {"loss": loss, "nll": nll, **om}

    return train_step


def _sharded(params) -> bool:
    """Whether ``params`` are DTensors (``dist.sharding.shard_params``)."""
    return common.is_dtensor(params.embed)


def _on_submesh(params, sub):
    """A copy of the module ``params`` whose tensors are DTensors over the
    DeviceMesh ``sub`` (the mesh without "pod") holding the same local
    shards, the storage shared: what one pod's ranks hold of params
    replicated over "pod"."""
    from torch import nn

    memo = {id(p): nn.Parameter(_drop_pod(p.detach(), sub), requires_grad=p.requires_grad)
            for p in params.parameters()}
    return copy.deepcopy(params, memo)


_VIEWS = weakref.WeakKeyDictionary()  # sharded params -> their one-pod views


def _pod_view(params, sub):
    """``_on_submesh(params, sub)``, built once a params (the storage is
    shared, so the optimizer's in-place updates show through)."""
    view = _VIEWS.get(params)
    if view is None:
        view = _VIEWS[params] = _on_submesh(params, sub)
    return view


def _drop_pod(t, sub):
    """A DTensor over the whole mesh as one pod holds it, over ``sub``: the
    same local shard, without the pod entry of its placements (replicated
    over "pod", or its dim 0 split pod-major: one pod's share of a batch or
    a cache)."""
    from torch.distributed.tensor import DTensor

    keep = [pl for name, pl in zip(t.device_mesh.mesh_dim_names, t.placements) if name != "pod"]
    return DTensor.from_local(t.to_local(), sub, keep, run_check=False)


def _lift(t, dm, split: bool = True):
    """A DTensor over ``sub`` holding one pod's rows (dim 0) as a DTensor
    over the whole mesh ``dm``: dim 0 split over "pod" first, or with
    ``split`` false (a batch that does not split over the pods: each pod
    runs all its rows) replicated over "pod"."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    keep = iter(t.placements)
    pod = Shard(0) if split else Replicate()
    pl = [pod if name == "pod" else next(keep) for name in dm.mesh_dim_names]
    return DTensor.from_local(t.to_local(), dm, pl, run_check=False)


def _pod_mean(grads: dict, axis, grad_sync: str, plan) -> dict:
    """Each gradient's mean over the pod axis, a leaf at a time: the ring
    (``tree_all_reduce_mean`` with ``plan``) for "seqbalance", one
    all-reduce (``baseline_all_reduce``) for "xla"."""
    if grad_sync == "seqbalance":
        return _sync(grads, axis, plan)
    n = axis.size
    return {name: collectives.baseline_all_reduce(grads.pop(name), axis).div_(n)
            for name in list(grads)}


def _sharded_train_step(cfg, opt_cfg, mesh, grad_sync, plan):
    """The FSDP + TP step on DTensor state over ``mesh`` (a "process" mesh),
    as the JAX package's step jitted with the production rule's
    ``in_shardings``: the loss and its gradients through DTensor, each
    gradient's partial sums reduced onto its master's layout, AdamW on the
    local shards.

    On a mesh with a "pod" axis each pod runs the loss on its share of the
    batch over the mesh without "pod", and each gradient's local shard is
    then averaged over the pod subgroup: through the ring with ``plan``
    for ``grad_sync="seqbalance"`` (the JAX package's partial-manual
    ``shard_map``, manual over "pod": each pod's MoE units route its own
    tokens), in one all-reduce for "xla".  The JAX package's "xla" mode
    leaves the pod axis to GSPMD, which routes the global batch; so there
    the MoE units route every pod's tokens as one batch
    (``moe.routed_over`` the pod subgroup), and the pods' mean is the
    global batch's gradient, every pod having as many tokens."""
    from torch.distributed.tensor.experimental import implicit_replication

    pods = mesh.shape.get("pod", 1) > 1
    dm = mesh.to_device_mesh()
    sub = mesh_mod.submesh(dm, tuple(a for a in mesh.axis_names if a != "pod")) if pods else None
    axis = mesh.axis("pod") if pods else None

    def pod_grads(params, batch):
        view = _pod_view(params, sub)
        for p in view.parameters():
            p.grad = None
        share = {k: _drop_pod(v, sub) for k, v in batch.items()}
        with moe.routed_over(axis.group if grad_sync == "xla" else None):
            loss, metrics = model.loss_fn(view, cfg, share)
            loss.backward()
        grads = weights.stacked(
            (name, i, torch.zeros_like(p.to_local()) if p.grad is None
             else p.grad.redistribute(sub, p.placements).to_local())
            for name, i, p in weights.leaves(view))
        for p in view.parameters():
            p.grad = None
        n = axis.size
        loss = collectives.baseline_all_reduce(loss.full_tensor().detach(), axis) / n
        nll = collectives.baseline_all_reduce(metrics["nll"].full_tensor().detach(), axis) / n
        return loss, nll, _pod_mean(grads, axis, grad_sync, plan)

    def train_step(state, batch):
        params = state["params"]
        if not common.is_dtensor(next(iter(batch.values()))):
            batch = sharding.shard_batch(batch, mesh)
        with implicit_replication():
            if pods:
                loss, nll, grads = pod_grads(params, batch)
            else:
                for p in params.parameters():
                    p.grad = None
                loss, metrics = model.loss_fn(params, cfg, batch)
                loss.backward()
                loss, nll, grads = (loss.full_tensor().detach(),
                                    metrics["nll"].full_tensor().detach(), None)
            params, opt, om = opt_mod.update(grads, state["opt"], params, opt_cfg)
        for p in params.parameters():
            p.grad = None
        return {"params": params, "opt": opt}, {"loss": loss, "nll": nll, **om}

    return train_step


def make_train_step(cfg, opt_cfg: opt_mod.AdamWConfig, mesh=None, grad_sync: str = "xla",
                    plan=None):
    """``train_step(state, batch) -> (state, {"loss", "nll", "grad_norm",
    "lr"})``; ``state`` is ``init_state``'s, its masters and moments updated
    in place.  On a "process" mesh whose state is sharded
    (``dist.sharding.shard_params`` and ``shard_opt_state``), the FSDP + TP
    step (``_sharded_train_step``; a batch that is not a DTensor is
    sharded by ``batch_specs``).  Else, with ``grad_sync="seqbalance"`` and
    a ``pod`` axis of more than one member on ``mesh`` (``launch.mesh``),
    the pod step over it with ``plan`` (the grad sync's PathPlan; ``None``:
    the default plan); else the single-device step, which reads neither."""
    if grad_sync not in ("xla", "seqbalance"):
        raise ValueError(f"grad_sync {grad_sync!r}")
    if grad_sync == "seqbalance" and mesh is not None and mesh.shape.get("pod", 1) > 1:
        plain = _pod_train_step(cfg, opt_cfg, mesh, plan)
    else:
        plain = _single_train_step(cfg, opt_cfg)
    if mesh is None or mesh.transport != "process" or len(mesh.sizes) == 1:
        return plain
    built = {}

    def train_step(state, batch):
        if not _sharded(state["params"]):
            return plain(state, batch)
        if "step" not in built:
            built["step"] = _sharded_train_step(cfg, opt_cfg, mesh, grad_sync, plan)
        return built["step"](state, batch)

    return train_step


def _single_train_step(cfg, opt_cfg):
    """The single-device step: autograd over ``model.loss_fn``, then AdamW
    on each master's ``.grad``."""

    def train_step(state, batch):
        params = state["params"]
        for p in params.parameters():
            p.grad = None
        loss, metrics = model.loss_fn(params, cfg, batch)
        loss.backward()
        params, opt, om = opt_mod.update(None, state["opt"], params, opt_cfg)
        for p in params.parameters():
            p.grad = None
        return {"params": params, "opt": opt}, {"loss": loss.detach(),
                                                "nll": metrics["nll"].detach(), **om}

    return train_step


def _serving(params, batch: dict):
    """Sharded ``params`` and ``batch`` as one pod runs them: on a mesh with
    a "pod" axis (pure data parallelism: serving's pods are replicas), the
    params' views over the mesh without "pod" (``_pod_view``) and this pod's share of the batch (laid out by
    ``batch_specs`` first, unless made of DTensors); else both as they
    are.  Returns (params, batch, the mesh they run on, to_pod, lift,
    pods): ``to_pod`` takes a DTensor of the whole mesh to the pod's,
    ``lift`` one of the pod's back (``_drop_pod``, ``_lift``); ``pods`` is
    the pod subgroup where the pods split the rows (``moe.routed_over`` it:
    the JAX package's serving steps leave the pod axis to GSPMD, which
    routes the whole batch), else ``None``."""
    dm = params.embed.device_mesh
    if not common.is_dtensor(next(iter(batch.values()))):
        batch = sharding.shard_batch(batch, dm)
    names = tuple(dm.mesh_dim_names)
    if "pod" not in names or dm.size(names.index("pod")) == 1:
        return params, batch, dm, (lambda t: t), (lambda t: t), None
    sub = mesh_mod.submesh(dm, tuple(a for a in names if a != "pod"))
    split = next(iter(batch.values())).placements[names.index("pod")].is_shard(0)
    return (_pod_view(params, sub), {k: _drop_pod(v, sub) for k, v in batch.items()}, sub,
            lambda t: _drop_pod(t, sub), lambda t: _lift(t, dm, split),
            dm.get_group("pod") if split else None)


def _map_cache(fn, cache):
    """``fn`` over each tensor of a cache, its structure and ints kept."""
    def unit(c):
        if hasattr(c, "_asdict"):
            return type(c)(**{f: fn(v) if isinstance(v, torch.Tensor) else v
                              for f, v in c._asdict().items()})
        return tuple(fn(v) if isinstance(v, torch.Tensor) else v for v in c)

    return {"prelude": tuple(unit(c) for c in cache["prelude"]),
            "main": [tuple(unit(c) for c in sb) for sb in cache["main"]],
            "trailing": tuple(unit(c) for c in cache["trailing"])}


def serving_cache(params, cfg, batch: int, max_len: int):
    """The empty cache of ``batch`` rows laid out as ``make_prefill_step``
    returns it for sharded ``params``: ``cache_specs`` over the mesh one
    pod runs on, for its share of the rows, lifted over the whole mesh;
    each leaf made as its device's block (``sharding.empty_cache``)."""
    from torch.distributed.tensor.experimental import implicit_replication

    rows = torch.zeros((batch, 1), dtype=torch.int32, device=params.device)
    params, share, mesh, _, lift, _ = _serving(params, {"tokens": rows})
    B = share["tokens"].shape[0]
    with implicit_replication():
        cache = sharding.empty_cache(cfg, mesh, B, max_len, device=params.device)
    return _map_cache(lift, cache)


def make_prefill_step(cfg, max_len: int):
    """``prefill_step(params, batch) -> (last logits, cache)``.  On sharded
    params the inputs are laid out by ``batch_specs`` and the cache comes
    out laid out by ``cache_specs`` (the JAX dry run's ``out_shardings``);
    on a pod mesh each pod prefills its share of the rows (``_serving``)
    into a cache laid out for its share (``serving_cache``), its MoE units
    routing every pod's rows.  The units fill a cache laid out as their
    rows (the recurrent states start there, and nothing moves to write
    it), made as each device's block (``sharding.empty_cache``), which
    ``dist.sharding.relayout`` then moves once to ``cache_specs``, leaf by
    leaf, each rows copy freed as it goes."""

    def prefill_step(params, batch):
        if not _sharded(params):
            return model.prefill(params, cfg, batch, max_len)
        from torch.distributed.tensor.experimental import implicit_replication

        params, batch, mesh, _, lift, pods = _serving(params, batch)
        B = next(iter(batch.values())).shape[0]
        with implicit_replication(), moe.routed_over(pods):
            cache = sharding.empty_cache(cfg, mesh, B, max_len, rows=True, device=params.device)
            logits, cache = model.prefill(params, cfg, batch, max_len, cache=cache)
        cache = sharding.shard_cache(cache, cfg, mesh, B, max_len)
        return lift(logits), _map_cache(lift, cache)

    return prefill_step


def make_serve_step(cfg):
    """One decode step: greedy next token against the KV cache (on sharded
    params, the tokens laid out by ``batch_specs`` and the cache as the
    prefill step returns it, each pod decoding its share of the rows)."""

    def serve_step(params, tokens, cache):
        if not _sharded(params):
            logits, cache = model.decode_step(params, cfg, tokens, cache)
        else:
            from torch.distributed.tensor.experimental import implicit_replication

            params, batch, _, to_pod, lift, pods = _serving(params, {"tokens": tokens})
            with implicit_replication(), moe.routed_over(pods):
                logits, cache = model.decode_step(params, cfg, batch["tokens"],
                                                  _map_cache(to_pod, cache))
            logits, cache = lift(logits), _map_cache(lift, cache)
        # the vocab gathered first: DTensor's argmax over a sharded dim reads
        # its shards' results on the host
        next_tok = torch.argmax(common.gathered_on(logits, (1,)), dim=-1).to(torch.int32)[:, None]
        return next_tok, logits, cache

    return serve_step


def init_state(cfg, seed: int = 0, device=None) -> dict:
    """{"params": float32 masters from ``model.init_params`` (``device``:
    ``None`` means ``"cuda"``), "opt": zero moments}."""
    params = model.init_params(cfg, seed, device=device, trainable=True)
    return {"params": params, "opt": opt_mod.init(params)}
