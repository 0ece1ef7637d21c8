"""Shared model substrate: norms, RoPE, activations, init helpers."""
from __future__ import annotations

import contextlib
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn


def span(name: str):
    """A ``torch.profiler`` range named ``name`` while the profiler records
    (a profile reads the device time of the work inside it), else
    nothing."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """In float32, scaled by ``1 + scale``; returns x's dtype."""
    dt = x.dtype
    x = x.to(torch.float32)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + scale.to(torch.float32))).to(dt)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if not cap:
        return x
    return cap * torch.tanh(x / cap)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding of the two halves of the head dim (not interleaved
    pairs), in float32. x: [..., S, H, hd]; positions: [..., S]."""
    hd = x.shape[-1]
    half = hd // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].to(torch.float32) * freq  # [..., S, half]
    cos = torch.cos(ang)[..., None, :]  # [..., S, 1, half]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _squared_relu(x):
    return torch.square(F.relu(x))


def _gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


def act_fn(kind: str):
    if kind == "gated_silu" or kind == "silu":
        return F.silu
    if kind == "gated_gelu" or kind == "gelu":
        return _gelu_tanh
    if kind == "squared_relu":
        return _squared_relu
    raise ValueError(kind)


def dense_init(shape, generator: torch.Generator, in_axis_size: int | None = None,
               dtype=torch.float32) -> torch.Tensor:
    """Truncated normal (at +-2 sigma) scaled by fan_in ** -0.5, drawn in
    float32 on the generator's device from ``generator`` (by the inverse
    CDF of a uniform draw), then cast to ``dtype``."""
    fan_in = in_axis_size if in_axis_size is not None else shape[0]
    std = (1.0 / max(fan_in, 1)) ** 0.5
    lo, hi = (0.5 * (1.0 + math.erf(b / math.sqrt(2.0))) for b in (-2.0, 2.0))
    t = torch.empty(shape, dtype=torch.float32, device=generator.device)
    t.uniform_(2.0 * lo - 1.0, 2.0 * hi - 1.0, generator=generator)
    t.erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0).mul_(std)
    return t.to(dtype)


class Field(NamedTuple):
    """How one parameter of a unit is made and held: its shape; its init,
    "dense" (``dense_init`` over ``fan_in``), "zeros", "ones" or "lam" (the
    RG-LRU's logit(linspace(0.9, 0.999, R)), ``recurrent.py:281`` of the
    JAX package); and ``f32``, whether it is held in float32 (the JAX
    package reads it in float32) or in the compute dtype."""

    shape: tuple
    init: str = "dense"
    fan_in: int = 0
    f32: bool = False


def dense(shape, fan_in: int, f32: bool = False) -> Field:
    return Field(tuple(shape), "dense", fan_in, f32)


def norm(shape) -> Field:
    """A norm scale: zeros, float32 (applied as ``1 + scale``)."""
    return Field(tuple(shape), "zeros", f32=True)


def init_field(f: Field, generator: torch.Generator, dtype) -> torch.Tensor:
    """A parameter as the JAX package initializes it (from another random
    stream), on the generator's device, in its held dtype."""
    dev = generator.device
    if f.init == "dense":
        return dense_init(f.shape, generator, f.fan_in, torch.float32 if f.f32 else dtype)
    if f.init == "zeros":
        return torch.zeros(f.shape, dtype=torch.float32, device=dev)
    if f.init == "ones":
        return torch.ones(f.shape, dtype=torch.float32, device=dev)
    if f.init == "lam":
        a = torch.linspace(0.9, 0.999, f.shape[-1], dtype=torch.float32, device=dev)
        return torch.log(a / (1 - a)).expand(f.shape).clone()
    raise ValueError(f.init)


def master_dtype(cfg, trainable: bool):
    """The dtype of trainable masters (``cfg.param_dtype``), or ``None``:
    frozen weights held in the dtype they are read in."""
    return getattr(torch, cfg.param_dtype) if trainable else None


class ParamModule(nn.Module):
    """A unit's tensors under the JAX package's field names.  ``FIELDS``
    names them in the JAX NamedTuple's order; ``fields`` (the unit's
    ``Field`` table) says which are read in float32 (those the JAX package
    reads in float32: norm scales, the router, the recurrences' gates and
    Lambda) and which in the compute dtype ``dtype``.

    Without ``master`` (serving) each is held frozen in the dtype it is read
    in.  With ``master`` (training: ``cfg.param_dtype``, float32) each is a
    master in that dtype that takes a gradient, and reading the attribute
    casts it to the dtype it is read in, as the JAX package casts its
    float32 masters at each use; autograd brings each use's gradient back
    to float32 before it accumulates.  The masters themselves are in
    ``_parameters`` (``weights.leaves``)."""

    FIELDS: tuple[str, ...] = ()

    def __init__(self, fields: dict, dtype=None, device=None, master=None, **tensors):
        super().__init__()
        if set(tensors) != set(self.FIELDS) or set(fields) != set(self.FIELDS):
            raise ValueError(f"{type(self).__name__} takes {self.FIELDS}, got {sorted(tensors)}")
        self._read_as = {}
        for name in self.FIELDS:
            read_as = torch.float32 if fields[name].f32 else dtype
            t = torch.as_tensor(tensors[name])
            if master is None:
                t = t.to(device=device, dtype=read_as)
            else:  # a copy of its own: the optimizer writes it in place
                t = t.to(device=device, dtype=master, copy=True)
            self.register_parameter(name, nn.Parameter(t, requires_grad=master is not None))
            self._read_as[name] = read_as

    def __getattr__(self, name: str):
        t = super().__getattr__(name)
        read_as = self.__dict__.get("_read_as", {}).get(name)
        return t if read_as is None else t.to(read_as)  # a no-op on serving's weights
