"""The NIC-tiered hop cascade: the dataplane step that every scheme except
DRILL runs once per ``dt`` step.

``cascade_tiered`` launches the hand-written CUDA kernel
``csrc/cascade_tiered.cu`` (it replaces the JAX package's Pallas kernel
``kernels/linkload.py::linkload_cascade_tiered``) on CUDA tensors, and
runs ``cascade_tiered_torch``, its plain PyTorch version, on CPU tensors.
The kernel spreads each simulation over a thread-block cluster of
``cluster_size(W, N, L + 1)`` CTAs (``kernels/cascade_common.py``, whose
``cluster_size`` and ``MAX_CLUSTER`` this module re-exports);
``cascade_tiered.cluster_launches`` counts the launches by that size.

Layout (the sentinel layout of ``netsim.dataplane.cascade_nic``): B
simulations, W flows of N sub-flows, Hf fabric hops, L real links plus a
sentinel slot L with capacity 1e30 onto which absent (-1) hops land, so
an absent hop scales by exactly 1.

  fab  i32[B, W, N, Hf]   tx, rx  i32[B, W]   rates  f32[B, W, N]
  queue f32[B, L + 1]     capacity, queue_mask  f32[L + 1]
  -> arrival, new_queue, p_mark  f32[B, L + 1],  thr  f32[B, W, N]

with ``arrival[:, L] == 0`` and ``p_mark[:, L] == 0``.

The kernel sums link loads in int64 fixed point (1/64 bps a unit,
``cascade_common.FIXED_UNITS_PER_BPS``), so a launch repeats bit for bit;
``W * N`` is checked against the overflow bound
(``cascade_common.check_fixed_point``: at most 360,287 sub-flows of up to
400 Gb/s).  The plain version sums floats with ``index_add_``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.cascade_common import (  # noqa: F401 (re-exported)
    CASCADE_SMEM_PER_LINK, MAX_CLUSTER, check_cluster, check_fixed_point, check_smem,
    cluster_size, device_index, gather, red_mark, scale, segment_sum,
)

_p, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = (_p,) * 11 + (_i,) * 6 + (_f,) * 5 + (_p,)


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
        load = segment_sum(vals, idx, L1)
        return load, torch.where(real > 0, load, torch.zeros_like(load))

    load, arrival = hop_load(rates.sum(-1), tx)
    r = rates * gather(scale(load, capacity), tx)[..., None]
    lid = torch.where(fab >= 0, fab, torch.full_like(fab, nl)).reshape(B, W * N, hf)
    rf = r.reshape(B, W * N)
    for h in range(hf):
        lh = lid[:, :, h]
        load, real_load = hop_load(rf, lh)
        arrival = arrival + real_load
        rf = rf * gather(scale(load, capacity), lh)
    r = rf.reshape(B, W, N)
    load, real_load = hop_load(r.sum(-1), rx)
    arrival = arrival + real_load
    thr = r * gather(scale(load, capacity), rx)[..., None]
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
    check_smem("cascade_tiered", CASCADE_SMEM_PER_LINK, L1)
    check_fixed_point("cascade_tiered", W * N)
    C = cluster_size(W, N, L1)
    check_cluster("cascade_tiered", device_index(dev), C, L1)
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
