"""The NIC-tiered hop cascade: the dataplane step that every scheme except
DRILL runs once per ``dt`` step.

``cascade_tiered`` launches the hand-written CUDA kernel
``csrc/cascade_tiered.cu`` (it replaces the JAX package's Pallas kernel
``kernels/linkload.py::linkload_cascade_tiered``) on CUDA tensors, and
runs ``cascade_tiered_torch``, its plain PyTorch version, on CPU tensors.

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

import torch

from repro_torch.kernels import build

MAX_SMEM = 232448  # bytes of shared memory one block may use on Hopper
_p, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = (_p,) * 11 + (_i,) * 5 + (_f,) * 5 + (_p,)


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
    if 2 * L1 * 4 > MAX_SMEM:
        raise ValueError(f"{L1} links need {2 * L1 * 4} B of shared memory; "
                         f"a block has {MAX_SMEM}")
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
                 thr.data_ptr(), B, W, N, hf, L1, kmin, kmax, pmax, dt,
                 qmax_bytes, stream)
    build.raise_on(err, "cascade_tiered")
    build.count_launch(cascade_tiered)
    return arrival, new_queue, p_mark, thr


cascade_tiered.launches = 0
