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


def real_tensors():
    """A context in which tensors are real even inside a ``FakeTensorMode``
    (a DeviceMesh holds its ranks in a tensor that it reads)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily

    return unset_fake_temporarily()


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (a sharded step's tensor)."""
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def records(*tensors) -> bool:
    """Whether autograd records an operation on ``tensors``."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def from_local(t, mesh, placements, shape):
    """The DTensor of contiguous global ``shape`` over ``mesh`` laid out as
    ``placements`` whose block on this device is ``t``."""
    from torch.distributed.tensor import DTensor

    shape = torch.Size(shape)
    return DTensor.from_local(t, mesh, placements, run_check=False, shape=shape,
                              stride=contiguous_stride(shape))


def contiguous_stride(shape) -> tuple:
    """The strides of a contiguous tensor of ``shape``, from the shape alone
    (a tensor on the meta device made for them is, inside a
    ``FakeTensorMode``, a fake tensor of the whole global shape that the
    dry run's count of live bytes sees)."""
    out, step = [], 1
    for n in reversed(tuple(shape)):
        out.append(step)
        step *= max(n, 1)
    return tuple(reversed(out))


def no_source() -> dict:
    """``distribute_tensor``'s keyword for a tensor that every rank already
    holds whole (each keeps its block, nothing is sent), where the
    installed torch has it."""
    import inspect

    from torch.distributed.tensor import distribute_tensor

    if "src_data_rank" in inspect.signature(distribute_tensor).parameters:
        return {"src_data_rank": None}
    return {}


def _shards_on(t, dim: int) -> int:
    """How many shards a DTensor ``t`` has along ``dim``."""
    n = 1
    for d, pl in enumerate(t.placements):
        if pl.is_shard(dim):
            n *= t.device_mesh.size(d)
    return n


def gathered_on(t, dims):
    """``t`` replicated on every mesh dim that shards one of ``dims`` where it
    is a DTensor, else as it is."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate

    out = [Replicate() if any(pl.is_shard(d) for d in dims) else pl for pl in t.placements]
    return t if out == list(t.placements) else t.redistribute(t.device_mesh, out)


def whole(t):
    """A DTensor gathered whole on this device (a weight a device's code
    takes whole), as a plain tensor; a plain tensor as it is."""
    return t.full_tensor() if is_dtensor(t) else t


def fsdp_gathered(t):
    """A DTensor weight as a step uses it: gathered whole over the
    data-parallel mesh dims ("data", "pod"), still split over "model"
    (FSDP's gather before use; its gradient's backward is the
    reduce-scatter).  Left to itself DTensor would rather move the batch's
    activations than the weight, and hold a product over the whole batch
    on a device.  A plain tensor as it is."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate

    out = [Replicate() if name in ("data", "pod") else pl
           for name, pl in zip(t.device_mesh.mesh_dim_names, t.placements)]
    return t if out == list(t.placements) else t.redistribute(t.device_mesh, out)


def roll(t, shift: int, dim: int):
    """``torch.roll`` along ``dim``; a DTensor (which has no rule for it in
    every torch) gathered along ``dim`` and rolled shard by shard."""
    if not is_dtensor(t):
        return torch.roll(t, shift, dim)
    from torch.distributed.tensor import DTensor

    t = gathered_on(t, (dim % t.dim(),))
    return DTensor.from_local(torch.roll(t.to_local(), shift, dim), t.device_mesh,
                              t.placements, run_check=False, shape=t.shape,
                              stride=t.stride())


def batch_placements(mesh, rows: int) -> list:
    """The placements over ``mesh`` of a tensor whose dim 0 is a batch of
    ``rows``, laid out as the residual stream: the batch over the mesh's
    data-parallel dims (those it divides, major first), replicated over
    "model".  Nothing is moved."""
    from torch.distributed.tensor import Replicate, Shard

    dp, out = 1, []
    for name, n in zip(mesh.mesh_dim_names, mesh.shape):
        if name != "model" and rows % (dp * n) == 0:
            dp *= n
            out.append(Shard(0))
        else:
            out.append(Replicate())
    return out


def batch_layout(x):
    """The residual stream's layout on a DTensor x [B, ...]
    (``batch_placements``), as a sharding constraint on the stream would
    hold it under GSPMD (DTensor left alone lets it drift: its embedding
    gather shards the model dim and the sequence instead).  A plain tensor
    as it is."""
    if not is_dtensor(x):
        return x
    out = batch_placements(x.device_mesh, x.shape[0])
    return x if list(x.placements) == out else x.redistribute(x.device_mesh, out)


class _Fence(torch.autograd.Function):
    """The identity, whose gradient is laid out as ``batch_layout`` lays the
    residual stream."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return batch_layout(g)


def fenced(t):
    """A DTensor activation whose gradient is laid out as the residual
    stream (its batch over the data-parallel dims, gathered over "model")
    before it reaches the reshape that made ``t``: the reshape's backward
    would otherwise split a shard DTensor chose into a strided one.  A
    plain tensor as it is."""
    return _Fence.apply(t) if is_dtensor(t) else t


def merge_ready(t, start: int, end: int):
    """``t`` ready for its dims ``start`` to ``end`` (inclusive) to be merged
    into one: a DTensor sharded on one of them after ``start`` gathered
    there (the merge would make a strided shard, which DTensor plans very
    slowly and GSPMD does not make; for a weight this is FSDP's gather
    before use).  A plain tensor as it is."""
    if not is_dtensor(t):
        return t
    start, end = start % t.dim(), end % t.dim()
    return gathered_on(t, range(start + 1, end + 1))


def split_ready(t, dim: int, first: int):
    """``t`` ready for its dim ``dim`` to be split into (``first``, rest): a
    DTensor whose shards along ``dim`` do not divide ``first`` gathered
    there (the heads do not split over the mesh).  A plain tensor as it
    is."""
    if not is_dtensor(t):
        return t
    dim = dim % t.dim()
    return t if first % _shards_on(t, dim) == 0 else gathered_on(t, (dim,))


def contract_ready(x, w, dim: int = -2):
    """x laid out for the product ``x @ w`` (batched or not) whose
    contraction is w's dim ``dim``: x's last dim split over each mesh dim
    that splits w's contraction and holds x whole (under the production
    rule, "model" where it lands on a weight's input dim), the rest of x's
    layout kept.  The product is then a partial sum there, and its weight
    gradient, x^T @ dy, comes out split as the weight is held: with x whole
    there DTensor may compute that gradient whole on every device and
    slice it (16 times the work on a "model" axis of 16).  Nothing moves:
    a replicated dim is split by slicing.  Plain tensors as they are."""
    if not (is_dtensor(x) and is_dtensor(w)):
        return x
    from torch.distributed.tensor import Shard

    dim = dim % w.dim()
    out = [Shard(x.dim() - 1) if wp.is_shard(dim) and xp.is_replicate() else xp
           for xp, wp in zip(x.placements, w.placements)]
    return x if out == list(x.placements) else x.redistribute(x.device_mesh, out)


class _GradAsOutput(torch.autograd.Function):
    """The identity on a DTensor, whose gradient is laid out as the output
    was (replicated where the output is a partial sum)."""

    @staticmethod
    def forward(ctx, t):
        from torch.distributed.tensor import Replicate

        ctx.placements = [Replicate() if p.is_partial() else p for p in t.placements]
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g if list(g.placements) == ctx.placements else g.redistribute(
            g.device_mesh, ctx.placements)


def matmul(x, w):
    """``x @ w`` with x laid out for w's sharding (``contract_ready``), and
    the product's gradient laid out as the product (a partial sum's
    replicated): DTensor would otherwise let a partial-sum gradient reach
    the product, whose backward then gathers the weight and computes the
    input's gradient whole.  So both gradients of the product are computed
    split as the weight is held."""
    y = contract_ready(x, w) @ w
    return _GradAsOutput.apply(y) if is_dtensor(y) else y


def laid_out(t, mesh, placements):
    """``t`` as a DTensor laid out as ``placements`` over ``mesh``: a
    DTensor redistributed, a plain tensor (the whole, the same on every
    device) distributed, each device keeping its block."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    if not is_dtensor(t):
        t = distribute_tensor(t, mesh, [Replicate()] * mesh.ndim, **no_source())
    return t.redistribute(mesh, placements)


def on_rows(fn, rows: tuple, whole: tuple):
    """``fn(*rows, *whole)`` on each device's own rows of the batch where
    some arguments are DTensors: each of ``rows`` (dim 0 the batch; a
    plain tensor is taken as the whole batch, the same on every device)
    laid out as ``batch_layout`` lays the residual stream, each of
    ``whole`` (weights) gathered whole, and ``fn`` run on the local
    tensors; its tensor outputs (dim 0 the batch) come back as DTensors
    laid out so.  Each argument is redistributed once, straight to its
    layout (``batch_placements`` reads the rows' layout without moving
    anything).  A whole argument's gradient is a partial sum over the
    devices that split the rows.  For a loop over time that DTensor would
    dispatch op by op (the sLSTM).  Without DTensors, ``fn(*rows,
    *whole)``."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.utils import _pytree as pytree

    ref = next((t for t in rows + whole if is_dtensor(t)), None)
    if ref is None:
        return fn(*rows, *whole)
    mesh = ref.device_mesh
    lead = next(t for t in rows if is_dtensor(t))
    layout = batch_placements(mesh, lead.shape[0])
    grads = [Partial() if p.is_shard() else Replicate() for p in layout]

    args = [laid_out(t, mesh, layout).to_local() for t in rows]
    args += [laid_out(t, mesh, [Replicate()] * mesh.ndim).to_local(grad_placements=grads)
             for t in whole]
    out = fn(*args)
    B = lead.shape[0]

    def back(o):
        return from_local(o, mesh, layout, (B, *o.shape[1:])) if isinstance(o, torch.Tensor) else o

    return pytree.tree_map(back, out)


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``F.logsigmoid``; on a DTensor, which has no rule for its backward,
    the same function as min(x, 0) - log1p(exp(-|x|)), the formula of
    torch's CPU kernel."""
    if is_dtensor(x):
        return torch.clamp(x, max=0.0) - torch.log1p(torch.exp(-torch.abs(x)))
    return F.logsigmoid(x)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """In float32, scaled by ``1 + scale``; returns x's dtype.  A DTensor
    scale (a vector the rule may shard, qwen3-32b's on "model") is
    gathered first, so that x keeps its layout."""
    dt = x.dtype
    scale = gathered_on(scale, range(scale.dim()))
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
        # a no-op on serving's weights; a sharded step's gathered over "data"
        return t if read_as is None else fsdp_gathered(t.to(read_as))
