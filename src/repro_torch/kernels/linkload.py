"""The flat hop cascade and the one-pass link load, each a hand-written CUDA
kernel with its plain PyTorch version beside it.

``linkload_cascade`` launches ``csrc/cascade_flat.cu`` (it replaces the
JAX package's Pallas kernel ``kernels/linkload.py::linkload_cascade``) and
``linkload`` launches ``csrc/linkload.cu`` (it replaces
``kernels/linkload.py::linkload``), on CUDA tensors; on CPU tensors they
run ``linkload_cascade_torch`` and ``linkload_torch``.  Each kernel runs
on a thread-block cluster (``kernels/cascade_common.py``): the flat
cascade one of ``cluster_size(n, 1, L + 1)`` CTAs per simulation,
``linkload`` one of ``cluster_size(n, hops, L)``; ``cluster_launches`` on
each wrapper counts its launches by that size.

The flat cascade uses the sentinel layout of ``netsim.dataplane.cascade``:
B simulations, n sub-flows of H hops, L real links plus a sentinel slot L
with capacity 1e30 onto which absent (-1) hops land, so an absent hop
scales by exactly 1.

  lid  i32[B, n, H]   rates f32[B, n]   queue f32[B, L + 1]
  capacity, queue_mask  f32[L + 1]
  -> arrival, new_queue, p_mark  f32[B, L + 1],  thr  f32[B, n]

Both kernels sum link loads in int64 fixed point, as the tiered cascade
does (``cascade_common.FIXED_UNITS_PER_BPS``), so a launch repeats bit for
bit.  Their plain versions keep the float ``index_add_``.

``linkload`` keeps the JAX entry point's unbatched layout, with no
sentinel slot: ids outside [0, L) are dropped.

  lid  i32[n, hops]   rates f32[n]   queue, capacity f32[L]
  -> load, new_queue, mark  f32[L]
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.cascade_common import (
    CASCADE_SMEM_PER_LINK, LINKLOAD_SMEM_PER_LINK, check_cluster, check_fixed_point,
    check_smem, cluster_size, device_index, gather, red_mark, scale, segment_sum,
)

QMAX_BYTES = 8e6  # linkload's fixed queue cap (the JAX kernel's)

_p, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_CASCADE_ARGTYPES = (_p,) * 9 + (_i,) * 5 + (_f,) * 5 + (_p,)
_LINKLOAD_ARGTYPES = (_p,) * 7 + (_i,) * 4 + (_f,) * 4 + (_p,)


def linkload_cascade_torch(lid, rates, queue, capacity, queue_mask, *, kmin: float,
                           kmax: float, pmax: float, dt: float, qmax_bytes: float):
    """Plain PyTorch version of the flat cascade kernel, mirroring
    ``kernels/ref.py::linkload_cascade_ref`` with ``index_add_``."""
    B = rates.shape[0]
    L1 = queue.shape[-1]
    nl = L1 - 1
    hops = lid.shape[-1]
    lid = torch.where(lid >= 0, lid, torch.full_like(lid, nl))
    r = rates
    arrival = torch.zeros((B, L1), dtype=torch.float32, device=rates.device)
    for h in range(hops):
        lh = lid[:, :, h]
        load = segment_sum(r, lh, L1)
        load_real = load.clone()
        load_real[:, nl] = 0.0
        arrival = arrival + load_real
        r = r * gather(scale(load, capacity), lh)
    new_queue = torch.clamp(queue + (arrival - capacity) * dt / 8.0, 0.0,
                            qmax_bytes) * queue_mask
    p_mark = red_mark(new_queue, kmin, kmax, pmax)
    p_mark[:, nl] = 0.0
    return arrival, new_queue, p_mark, r


def linkload_cascade(lid, rates, queue, capacity, queue_mask, *, kmin: float,
                     kmax: float, pmax: float, dt: float, qmax_bytes: float):
    """The flat cascade: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors.  ``linkload_cascade.launches`` counts the launches and
    ``linkload_cascade.cluster_launches`` counts them by cluster size."""
    dev = rates.device
    kw = dict(kmin=kmin, kmax=kmax, pmax=pmax, dt=dt, qmax_bytes=qmax_bytes)
    if dev.type == "cpu":
        return linkload_cascade_torch(lid, rates, queue, capacity, queue_mask, **kw)
    if dev.type != "cuda":
        raise ValueError(f"linkload_cascade runs on cuda or cpu tensors, not {dev}")
    B, n = rates.shape
    H = lid.shape[-1]
    L1 = queue.shape[-1]
    for name, t, dtype, shape in (
            ("lid", lid, torch.int32, (B, n, H)), ("rates", rates, torch.float32, (B, n)),
            ("queue", queue, torch.float32, (B, L1)),
            ("capacity", capacity, torch.float32, (L1,)),
            ("queue_mask", queue_mask, torch.float32, (L1,))):
        build.check(name, t, dtype, shape, dev)
    check_smem("cascade_flat", CASCADE_SMEM_PER_LINK, L1)
    check_fixed_point("cascade_flat", n)
    C = cluster_size(n, 1, L1)
    check_cluster("cascade_flat", device_index(dev), C, L1)
    arrival = torch.empty((B, L1), dtype=torch.float32, device=dev)
    new_queue = torch.empty_like(arrival)
    p_mark = torch.empty_like(arrival)
    thr = torch.empty((B, n), dtype=torch.float32, device=dev)
    fn = build.entry("cascade_flat", "cascade_flat_launch", _CASCADE_ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(lid.data_ptr(), rates.data_ptr(), queue.data_ptr(), capacity.data_ptr(),
                 queue_mask.data_ptr(), arrival.data_ptr(), new_queue.data_ptr(),
                 p_mark.data_ptr(), thr.data_ptr(), B, n, H, L1, C, kmin, kmax, pmax, dt,
                 qmax_bytes, stream)
    build.raise_on(err, f"cascade_flat (cluster of {C})")
    build.count_launch(linkload_cascade, linkload_cascade.cluster_launches, C)
    return arrival, new_queue, p_mark, thr


linkload_cascade.launches = 0
linkload_cascade.cluster_launches = {}


def linkload_torch(lid, rates, queue, capacity, *, kmin: float, kmax: float,
                   pmax: float, dt: float):
    """Plain PyTorch version of the linkload kernel, mirroring
    ``kernels/ref.py::linkload_ref``: ids outside [0, L) land on a dump
    slot that is cut off."""
    L = queue.shape[0]
    ok = (lid >= 0) & (lid < L)
    idx = torch.where(ok, lid, torch.full_like(lid, L)).to(torch.int64).reshape(-1)
    contrib = rates[:, None].expand(lid.shape).reshape(-1)
    load = torch.zeros(L + 1, dtype=torch.float32, device=rates.device)
    load = load.index_add_(0, idx, contrib)[:L]
    new_queue = torch.clamp(queue + (load - capacity) * dt / 8.0, 0.0, QMAX_BYTES)
    return load, new_queue, red_mark(new_queue, kmin, kmax, pmax)


def linkload(lid, rates, queue, capacity, *, kmin: float, kmax: float, pmax: float,
             dt: float):
    """One-pass link load, queue and mark: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors.  ``linkload.launches`` counts the
    launches and ``linkload.cluster_launches`` counts them by cluster size."""
    dev = rates.device
    kw = dict(kmin=kmin, kmax=kmax, pmax=pmax, dt=dt)
    if dev.type == "cpu":
        return linkload_torch(lid, rates, queue, capacity, **kw)
    if dev.type != "cuda":
        raise ValueError(f"linkload runs on cuda or cpu tensors, not {dev}")
    n, hops = lid.shape
    L = queue.shape[0]
    for name, t, dtype, shape in (
            ("lid", lid, torch.int32, (n, hops)), ("rates", rates, torch.float32, (n,)),
            ("queue", queue, torch.float32, (L,)),
            ("capacity", capacity, torch.float32, (L,))):
        build.check(name, t, dtype, shape, dev)
    check_smem("linkload", LINKLOAD_SMEM_PER_LINK, L)
    # a link's load is at most the sum over every (row, hop) of the row's rate
    check_fixed_point("linkload", n * hops)
    C = cluster_size(n, hops, L)
    check_cluster("linkload", device_index(dev), C, L)
    load = torch.empty((L,), dtype=torch.float32, device=dev)
    new_queue = torch.empty_like(load)
    mark = torch.empty_like(load)
    fn = build.entry("linkload", "linkload_launch", _LINKLOAD_ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(lid.data_ptr(), rates.data_ptr(), queue.data_ptr(), capacity.data_ptr(),
                 load.data_ptr(), new_queue.data_ptr(), mark.data_ptr(), n, hops, L, C,
                 kmin, kmax, pmax, dt, stream)
    build.raise_on(err, f"linkload (cluster of {C})")
    build.count_launch(linkload, linkload.cluster_launches, C)
    return load, new_queue, mark


linkload.launches = 0
linkload.cluster_launches = {}
