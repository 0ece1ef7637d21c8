"""AdamW + cosine schedule + global-norm clipping, mirroring
``repro.train.optimizer``, in float32 and in its order of operations.

The moments are keyed by the JAX package's leaf names
(``models.weights.leaves``), a "main" or "encoder" leaf stacked on its
[n_super] axis as there, so that a checkpoint of either package restores
into the other.  ``update`` writes the float32 masters and the moments in
place.  Every leaf decays, the norm scales and the embedding included, as
in the JAX package.  ``schedule`` and the clip scale are float32 tensors
on the params' device: no value is read back to the host.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.models import common, weights


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


class AdamWState(NamedTuple):
    step: torch.Tensor  # int32 []
    mu: dict  # leaf name -> float32 moment
    nu: dict


def init(params) -> AdamWState:
    """Zero moments in float32, one per leaf of ``params`` (a stacked leaf
    stacked), step 0, on the params' device."""
    named = [(name, i, torch.zeros_like(t, dtype=torch.float32))
             for name, i, t in weights.leaves(params)]
    mu = weights.stacked(named)
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=params.device), mu=mu,
                      nu={k: torch.zeros_like(v) for k, v in mu.items()})


def schedule(step: torch.Tensor, cfg: AdamWConfig) -> torch.Tensor:
    """Linear warmup to ``cfg.lr``, then cosine down to ``min_lr_frac`` of
    it: float32 [], each operation as ``optimizer.py:38-44`` of the JAX
    package rounds it."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    # the cosine of the float32 angle rounded once (torch.cos in float32
    # can land an ulp off, which the products below carry to 2-3 in lr)
    c = torch.cos((math.pi * prog).to(torch.float64)).to(torch.float32)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + c)
    return cfg.lr * warm * cos


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor, in float32.  Of DTensors
    (laid out without partial sums): each shard's sum of squares, the sums
    of the tensors laid out alike added on each device, and each such
    group reduced once over the mesh dims it is sharded on; a plain
    tensor."""
    tensors = list(tensors)
    if not any(common.is_dtensor(t) for t in tensors):
        return torch.sqrt(sum(torch.sum(torch.square(t.to(torch.float32))) for t in tensors))
    groups: dict = {}
    for t in tensors:
        s = torch.sum(torch.square(t.to(torch.float32)))
        groups.setdefault((s.device_mesh, s.placements), []).append(s)
    return torch.sqrt(sum(sum(ss).full_tensor() for ss in groups.values()))


def _local(t):
    """A DTensor's local shard (the tensor itself: writing it writes the
    DTensor), else ``t``."""
    return t.to_local() if common.is_dtensor(t) else t


def _grad(grads, name: str, i, p: torch.Tensor) -> torch.Tensor:
    """A leaf's gradient: from ``grads`` (leaf name -> the JAX layout's
    stacked array), else the master's ``.grad``; zeros where it has none
    (a parameter the loss does not read).  For a DTensor master, laid out
    as the master: a DTensor gradient redistributed (its partial sums
    reduced), a plain one taken as the master's local shard."""
    g = p.grad if grads is None else (grads[name] if i is None else grads[name][i])
    if g is None:
        return torch.zeros_like(p)
    if common.is_dtensor(p):
        from torch.distributed.tensor import DTensor

        if common.is_dtensor(g):
            return g.redistribute(p.device_mesh, p.placements)
        return DTensor.from_local(g, p.device_mesh, p.placements, run_check=False)
    return g


def update(grads, state: AdamWState, params, cfg: AdamWConfig):
    """One AdamW step on ``params``' masters, in place; returns (params,
    the new state, {"grad_norm", "lr"}).  ``grads``: leaf name -> gradient
    in the JAX layout, or ``None`` for each master's ``.grad``."""
    step = state.step + 1
    named = [(name, i, p, _grad(grads, name, i, p)) for name, i, p in weights.leaves(params)]
    gn = global_norm(g for _, _, _, g in named)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gn, min=1e-9), max=1.0)
    lr = schedule(step, cfg)
    t = step.to(torch.float32)
    b1c = 1 - torch.pow(cfg.b1, t)
    b2c = 1 - torch.pow(cfg.b2, t)
    with torch.no_grad():
        for name, i, p, g in named:
            m, v, p, g = _local(state.mu[name]), _local(state.nu[name]), _local(p), _local(g)
            if i is not None:
                m, v = m[i], v[i]
            g = g.to(torch.float32) * scale
            m.mul_(cfg.b1).add_(g * (1 - cfg.b1))
            v.mul_(cfg.b2).add_(torch.square(g).mul_(1 - cfg.b2))
            del g
            delta = (m / b1c).div_(torch.sqrt(v / b2c).add_(cfg.eps))
            delta.add_(cfg.weight_decay * p)
            p.sub_(delta.mul_(lr))
    return params, AdamWState(step=step, mu=state.mu, nu=state.nu), {"grad_norm": gn, "lr": lr}
