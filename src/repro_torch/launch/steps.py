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

import torch

from repro_torch.dist import collectives, sharding
from repro_torch.models import model, weights
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


def make_train_step(cfg, opt_cfg: opt_mod.AdamWConfig, mesh=None, grad_sync: str = "xla",
                    plan=None):
    """``train_step(state, batch) -> (state, {"loss", "nll", "grad_norm",
    "lr"})``; ``state`` is ``init_state``'s, its masters and moments updated
    in place.  With ``grad_sync="seqbalance"`` and a ``pod`` axis of more
    than one member on ``mesh`` (``launch.mesh``), the pod step over it
    with ``plan`` (the grad sync's PathPlan; ``None``: the default plan);
    else the single-device step, which reads neither."""
    if grad_sync not in ("xla", "seqbalance"):
        raise ValueError(f"grad_sync {grad_sync!r}")
    if grad_sync == "seqbalance" and mesh is not None and mesh.shape.get("pod", 1) > 1:
        return _pod_train_step(cfg, opt_cfg, mesh, plan)

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


def make_prefill_step(cfg, max_len: int):
    def prefill_step(params, batch):
        return model.prefill(params, cfg, batch, max_len)

    return prefill_step


def make_serve_step(cfg):
    """One decode step: greedy next token against the KV cache."""

    def serve_step(params, tokens, cache):
        logits, cache = model.decode_step(params, cfg, tokens, cache)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        return next_tok, logits, cache

    return serve_step


def init_state(cfg, seed: int = 0, device=None) -> dict:
    """{"params": float32 masters from ``model.init_params`` (``device``:
    ``None`` means ``"cuda"``), "opt": zero moments}."""
    params = model.init_params(cfg, seed, device=device, trainable=True)
    return {"params": params, "opt": opt_mod.init(params)}
