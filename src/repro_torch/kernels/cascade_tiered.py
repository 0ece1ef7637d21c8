"""The NIC-tiered hop cascade: the dataplane step that every scheme except
DRILL runs once per ``dt`` step.

``cascade_tiered`` launches the hand-written CUDA kernel
``csrc/cascade_tiered.cu`` (it replaces the JAX package's Pallas kernel
``kernels/linkload.py::linkload_cascade_tiered``) on CUDA tensors, and
runs ``cascade_tiered_torch``, its plain PyTorch version, on CPU tensors.
The kernel spreads each simulation over a thread-block cluster of
``cluster_size(W, N, L + 1)`` CTAs; ``cascade_tiered.cluster_launches`` counts
the launches by that size.

Layout (the sentinel layout of ``netsim.dataplane.cascade_nic``): B
simulations, W flows of N sub-flows, Hf fabric hops, L real links plus a
sentinel slot L with capacity 1e30 onto which absent (-1) hops land, so
an absent hop scales by exactly 1.

  fab  i32[B, W, N, Hf]   tx, rx  i32[B, W]   rates  f32[B, W, N]
  queue f32[B, L + 1]     capacity, queue_mask  f32[L + 1]
  -> arrival, new_queue, p_mark  f32[B, L + 1],  thr  f32[B, W, N]

with ``arrival[:, L] == 0`` and ``p_mark[:, L] == 0``.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build

MAX_SMEM = 232448  # bytes of shared memory one block may use on Hopper
MAX_CLUSTER = 16  # a non-portable cluster size, which the H100 admits (PERF.md)
_p, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = (_p,) * 11 + (_i,) * 6 + (_f,) * 5 + (_p,)


def cluster_size(W: int, N: int, n_links: int) -> int:
    """CTAs per simulation for W flows of N sub-flows on ``n_links`` link
    slots: the power of two nearest 2 sqrt(W N / n_links), in [1,
    MAX_CLUSTER].  A pass costs each CTA about W N / C scattered sub-flows
    plus C n_links partial loads summed over the cluster, which this
    balances (the factor 2 fits the H100's times in PERF.md).  fig12's
    batch (5,376 x 4 on 449 slots) and the dense shape get 16, the
    default three_tier (2,048 x 4 on 2,081) gets 4."""
    c = 2.0 * math.sqrt(W * N / n_links)
    return 1 if c <= 1.0 else min(MAX_CLUSTER, 2 ** round(math.log2(c)))


@functools.lru_cache(maxsize=None)
def _check_cluster(device_index: int, C: int, L1: int) -> None:
    """Raise unless the card can schedule a cluster of C CTAs of L1 links."""
    fn = build.entry("cascade_tiered", "cascade_tiered_max_clusters", (_i, _i, _p))
    count = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        build.raise_on(fn(C, L1, ctypes.byref(count)), "cascade_tiered occupancy")
    if count.value < 1:
        raise RuntimeError(f"cascade_tiered: the card cannot schedule a cluster of {C} CTAs "
                           f"with {L1} links")


def _segment_sum(vals: torch.Tensor, idx: torch.Tensor, size: int) -> torch.Tensor:
    """Per-simulation segment sum: vals, idx [B, M] -> [B, size]."""
    B = vals.shape[0]
    off = torch.arange(B, device=vals.device)[:, None] * size
    out = torch.zeros(B * size, dtype=vals.dtype, device=vals.device)
    out.index_add_(0, (idx.to(torch.int64) + off).reshape(-1), vals.reshape(-1))
    return out.view(B, size)


def _scale(load: torch.Tensor, capacity: torch.Tensor) -> torch.Tensor:
    return torch.clamp(capacity / torch.clamp(load, min=1.0), max=1.0)


def _gather(vec: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """vec [B, L1], idx [B, M] -> vec[b, idx[b, m]]."""
    return torch.gather(vec, 1, idx.to(torch.int64))


def red_mark(new_queue: torch.Tensor, kmin: float, kmax: float, pmax: float) -> torch.Tensor:
    """RED/ECN marking ramp on the queue bytes."""
    ramp = (new_queue - kmin) / (kmax - kmin)
    return torch.where(new_queue < kmin, torch.zeros_like(new_queue),
                       torch.where(new_queue > kmax, torch.ones_like(new_queue),
                                   ramp * pmax))


def cascade_tiered_torch(fab, tx, rx, rates, queue, capacity, queue_mask, *,
                         kmin: float, kmax: float, pmax: float, dt: float,
                         qmax_bytes: float):
    """Plain PyTorch version of the kernel, mirroring
    ``kernels/ref.py::linkload_cascade_tiered_ref`` with ``index_add_``."""
    B, W, N = rates.shape
    hf = fab.shape[-1]
    L1 = queue.shape[-1]
    nl = L1 - 1
    real = torch.ones(L1, dtype=rates.dtype, device=rates.device)
    real[nl] = 0.0

    def hop_load(vals, idx):
        load = _segment_sum(vals, idx, L1)
        return load, torch.where(real > 0, load, torch.zeros_like(load))

    load, arrival = hop_load(rates.sum(-1), tx)
    r = rates * _gather(_scale(load, capacity), tx)[..., None]
    lid = torch.where(fab >= 0, fab, torch.full_like(fab, nl)).reshape(B, W * N, hf)
    rf = r.reshape(B, W * N)
    for h in range(hf):
        lh = lid[:, :, h]
        load, real_load = hop_load(rf, lh)
        arrival = arrival + real_load
        rf = rf * _gather(_scale(load, capacity), lh)
    r = rf.reshape(B, W, N)
    load, real_load = hop_load(r.sum(-1), rx)
    arrival = arrival + real_load
    thr = r * _gather(_scale(load, capacity), rx)[..., None]
    new_queue = torch.clamp(queue + (arrival - capacity) * dt / 8.0, 0.0,
                            qmax_bytes) * queue_mask
    p_mark = red_mark(new_queue, kmin, kmax, pmax) * real
    return arrival, new_queue, p_mark, thr


def cascade_tiered(fab, tx, rx, rates, queue, capacity, queue_mask, *,
                   kmin: float, kmax: float, pmax: float, dt: float,
                   qmax_bytes: float):
    """The NIC-tiered cascade: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors.  ``cascade_tiered.launches`` counts the
    kernel launches."""
    dev = rates.device
    if dev.type == "cpu":
        return cascade_tiered_torch(fab, tx, rx, rates, queue, capacity, queue_mask,
                                    kmin=kmin, kmax=kmax, pmax=pmax, dt=dt,
                                    qmax_bytes=qmax_bytes)
    if dev.type != "cuda":
        raise ValueError(f"cascade_tiered runs on cuda or cpu tensors, not {dev}")
    B, W, N = rates.shape
    hf = fab.shape[-1]
    L1 = queue.shape[-1]
    for name, t, dtype, shape in (
            ("fab", fab, torch.int32, (B, W, N, hf)), ("tx", tx, torch.int32, (B, W)),
            ("rx", rx, torch.int32, (B, W)), ("rates", rates, torch.float32, (B, W, N)),
            ("queue", queue, torch.float32, (B, L1)),
            ("capacity", capacity, torch.float32, (L1,)),
            ("queue_mask", queue_mask, torch.float32, (L1,))):
        build.check(name, t, dtype, shape, dev)
    if 3 * L1 * 4 > MAX_SMEM:
        raise ValueError(f"{L1} links need {3 * L1 * 4} B of shared memory; "
                         f"a block has {MAX_SMEM}")
    C = cluster_size(W, N, L1)
    _check_cluster(dev.index if dev.index is not None else torch.cuda.current_device(), C, L1)
    arrival = torch.empty((B, L1), dtype=torch.float32, device=dev)
    new_queue = torch.empty_like(arrival)
    p_mark = torch.empty_like(arrival)
    thr = torch.empty((B, W, N), dtype=torch.float32, device=dev)
    fn = build.entry("cascade_tiered", "cascade_tiered_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(fab.data_ptr(), tx.data_ptr(), rx.data_ptr(), rates.data_ptr(),
                 queue.data_ptr(), capacity.data_ptr(), queue_mask.data_ptr(),
                 arrival.data_ptr(), new_queue.data_ptr(), p_mark.data_ptr(),
                 thr.data_ptr(), B, W, N, hf, L1, C, kmin, kmax, pmax, dt,
                 qmax_bytes, stream)
    build.raise_on(err, f"cascade_tiered (cluster of {C})")
    build.count_launch(cascade_tiered, cascade_tiered.cluster_launches, C)
    return arrival, new_queue, p_mark, thr


cascade_tiered.launches = 0
cascade_tiered.cluster_launches = {}
