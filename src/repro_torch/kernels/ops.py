"""Kernel entry points, mirroring ``repro.kernels.ops``: the hand-written
CUDA kernel on the card, its plain PyTorch version on the CPU.

Tensor arguments decide the device (they must all lie on one).  Arguments
that are not tensors (numpy arrays, lists) go to ``device``, where
``None`` means ``"cuda"``: without a CUDA device that raises.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.kernels import flash_attention as _fa, linkload as _ll



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
                    softcap: float = 0.0, device=None):
    """Causal GQA attention with an optional sliding window and tanh
    softcap: q [B, S, H, hd], k and v [B, S, K, hd], float32 or bfloat16;
    returns q's dtype and shape."""
    q, k, v = _placed((q, k, v), (None, None, None), device)
    return _fa.flash_attention(q, k, v, causal=causal, window=window, softcap=softcap)


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
