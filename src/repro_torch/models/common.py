"""Shared model substrate: norms, RoPE, activations, init helpers."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


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


class ParamModule(nn.Module):
    """A unit's tensors under the JAX package's field names, as frozen
    parameters.  ``FIELDS`` names them in the JAX NamedTuple's order and
    ``NORMS`` those that stay float32 (norm scales, which the JAX package
    casts to float32 where it reads them); the rest are cast once, at
    construction, to the compute dtype, as the JAX package casts them at
    each use."""

    FIELDS: tuple[str, ...] = ()
    NORMS: tuple[str, ...] = ()

    def __init__(self, dtype=None, device=None, **tensors):
        super().__init__()
        if set(tensors) != set(self.FIELDS):
            raise ValueError(f"{type(self).__name__} takes {self.FIELDS}, got {sorted(tensors)}")
        for name in self.FIELDS:
            t = torch.as_tensor(tensors[name])
            t = t.to(device=device, dtype=torch.float32 if name in self.NORMS else dtype)
            self.register_parameter(name, nn.Parameter(t, requires_grad=False))
