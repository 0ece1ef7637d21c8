"""Kernel entry points, mirroring ``repro.kernels.ops``: the hand-written
CUDA kernel on the card, its plain PyTorch version on the CPU.

Tensor arguments decide the device (they must all lie on one).  Arguments
that are not tensors (numpy arrays, lists) go to ``device``, where
``None`` means ``"cuda"``: without a CUDA device that raises.

Flash attention is a ``torch.library`` custom op,
``torch.ops.repro_torch.flash_attention``, so that a traced step sees it
whole: its fake implementation (``register_fake``) gives the output's
shape under ``FakeTensorMode`` without launching anything, and
``register_flash_sharding`` gives DTensor its rule (batch and heads
sharded, no communication; replicated where the heads do not split).  A
query block at an offset (``q_offset``, against a longer key range) is a
device's block of a sequence split over devices, which the caller
(``models.attention``) launches on its local tensors.
Its real implementation is the wrapper of ``kernels.flash_attention``, so
the same kernel launches as without the op.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.kernels import flash_attention as _fa, linkload as _ll


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, window: int,
              softcap: float, q_offset: int = 0) -> torch.Tensor:
    # contiguous, as the kernel's own output (a DTensor views its local shard)
    return _fa.flash_attention(q, k, v, causal=causal, window=window, softcap=softcap,
                               q_offset=q_offset).contiguous()


@_flash_op.register_fake
def _flash_fake(q, k, v, causal, window, softcap, q_offset=0):
    _fa.check_offset(q.shape[1], k.shape[1], q_offset)
    return torch.empty_like(q)


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def register_flash_sharding() -> None:
    """DTensor's rule for the flash op (once a process): every input and the
    output replicated, or sharded alike on the batch dim, or on the heads
    dim where the query and the KV heads split evenly over the shards the
    inputs come with (query head h reads KV head h // (H / K), which a
    contiguous split of both keeps; the KV heads may be fewer than the
    query heads' shards, a device's KV head repeated).  No rule moves data:
    the caller (``models.attention``) lays the inputs out first."""
    if register_flash_sharding.done:
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    @register_sharding(torch.ops.repro_torch.flash_attention.default)
    def rule(q, k, v, causal, window, softcap, q_offset=0):
        rest = [None, None, None, None]
        out = [([Replicate()], [Replicate()] * 3 + rest), ([Shard(0)], [Shard(0)] * 3 + rest)]
        n = 1
        for d, p in enumerate(q.placements):
            if p.is_shard(2):
                n *= q.mesh.size(d)
        if n > 1 and q.shape[2] % n == 0 and k.shape[2] % n == 0:
            out.append(([Shard(2)], [Shard(2)] * 3 + rest))
        return out

    register_flash_sharding.done = True


register_flash_sharding.done = False


def _placed(arrays, dtypes, device):
    """The arguments as tensors on one device: that of the tensors among
    them, else ``device``."""
    devs = {a.device for a in arrays if isinstance(a, torch.Tensor)}
    if len(devs) > 1:
        raise ValueError(f"arguments lie on several devices: {sorted(map(str, devs))}")
    if devs:
        dev = devs.pop()
        if device is not None and torch.device(device).type != dev.type:
            raise ValueError(f"device={device!r}, but the tensors lie on {dev}")
    else:
        dev = resolve_device(device)
    return [torch.as_tensor(a, dtype=d, device=dev).contiguous()
            for a, d in zip(arrays, dtypes)]


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, q_offset: int = 0, device=None):
    """Causal GQA attention with an optional sliding window and tanh
    softcap: q [B, S, H, hd], k and v [B, S, K, hd], float32 or bfloat16;
    returns q's dtype and shape.  With ``q_offset`` q [B, Sq, H, hd] is the
    block of rows [q_offset, q_offset + Sq) against k and v [B, Sk, K, hd]
    (``kernels.flash_attention``)."""
    if torch.is_grad_enabled() and any(getattr(t, "requires_grad", False) for t in (q, k, v)):
        raise RuntimeError("flash_attention has no backward: it refuses inputs that "
                           "require grad")
    if not any(_is_dtensor(t) for t in (q, k, v)):
        q, k, v = _placed((q, k, v), (None, None, None), device)
    return torch.ops.repro_torch.flash_attention(q, k, v, causal, int(window), float(softcap),
                                                 int(q_offset))


def linkload(link_ids, rates, queue, capacity, *, n_links: int, kmin: float = 400e3,
             kmax: float = 1600e3, pmax: float = 0.2, dt: float = 10e-6, device=None):
    """(load, new_queue, mark) f32[n_links] of link_ids i32[n, hops] (-1 and
    ids >= n_links dropped), rates f32[n], queue f32[n_links] and capacity
    f32[>= n_links].

    On the card the link loads are summed in int64 fixed point
    (``cascade_common.FIXED_UNITS_PER_BPS``), so that every run gives the
    same bits.  That holds rates within ``cascade_common.RATE_BOUND_BPS``
    (400 Gb/s; DCQCN clamps the engine's to the line rate) and refuses
    ``n * hops`` above 360,287: a rate past the bound can wrap a link's
    sum, and nothing checks it, since that would read the rates back to
    the host."""
    lid, rates, queue, capacity = _placed(
        (link_ids, rates, queue, capacity),
        (torch.int32, torch.float32, torch.float32, torch.float32), device)
    return _ll.linkload(lid, rates, queue[:n_links].contiguous(),
                        capacity[:n_links].contiguous(), kmin=kmin, kmax=kmax,
                        pmax=pmax, dt=dt)
