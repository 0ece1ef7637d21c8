"""What the link-load kernels' wrappers share (``cascade_tiered``,
``linkload_cascade`` and ``linkload``): the cluster size each asks for, the
check that the card can schedule it, the shared-memory limit, and the
segment helpers of their plain versions.

Each kernel spreads one simulation over a thread-block cluster of C CTAs
(``csrc/cascade_common.cuh``); each library exposes
``<library>_max_clusters(C, n_links, &count)`` for the occupancy check.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build

MAX_SMEM = 232448  # bytes of shared memory one block may use on Hopper
MAX_CLUSTER = 16  # a non-portable cluster size, which the H100 admits (PERF.md)

# The link-load kernels sum link loads in int64 fixed point (csrc/
# cascade_common.cuh): FIXED_UNITS_PER_BPS units a bit/s, so that a sum
# does not depend on the order of its additions.  A sub-flow's rate is at
# most RATE_BOUND_BPS (DCQCN clamps rates to the line rate, and no link of
# the port is faster than 160 Gb/s), so n sub-flows cannot overflow while
# n * RATE_BOUND_BPS * FIXED_UNITS_PER_BPS < 2**63: n <= 360,287.
FIXED_UNITS_PER_BPS = 64
RATE_BOUND_BPS = 400e9
# Per link slot in the cascades' shared memory: the int64 partial load,
# the float scale and the float running arrival.
CASCADE_SMEM_PER_LINK = 8 + 4 + 4
# Per link slot in linkload's shared memory: the int64 partial load.
LINKLOAD_SMEM_PER_LINK = 8


def cluster_size(rows: int, per_row: int, n_links: int) -> int:
    """CTAs per simulation for ``rows`` rows of ``per_row`` scattered items
    on ``n_links`` link slots: the power of two nearest 2 sqrt(rows
    per_row / n_links), in [1, MAX_CLUSTER].  A pass costs each CTA about
    rows per_row / C scattered items plus C n_links partial loads summed
    over the cluster, which this balances (the factor 2 fits the H100's
    times in PERF.md).  The tiered cascade asks for (W, N, L + 1), the flat
    one for (n, 1, L + 1), ``linkload`` for (n, hops, L): fig12's batch
    (21,504 sub-flows on 449 slots) and the dense shape get 16, the default
    three_tier (8,192 on 2,081) gets 4."""
    c = 2.0 * math.sqrt(rows * per_row / n_links)
    return 1 if c <= 1.0 else min(MAX_CLUSTER, 2 ** round(math.log2(c)))


def check_smem(name: str, bytes_per_link: int, n_links: int) -> None:
    """Raise unless ``bytes_per_link`` bytes of shared memory for each of
    ``n_links`` link slots fit in one block."""
    need = bytes_per_link * n_links
    if need > MAX_SMEM:
        raise ValueError(f"{name}: {n_links} links need {need} B of shared memory; "
                         f"a block has {MAX_SMEM}")


def check_fixed_point(name: str, n_subflows: int) -> None:
    """Raise unless the fixed-point link loads of ``n_subflows`` sub-flows
    at RATE_BOUND_BPS each fit in an int64."""
    if n_subflows * RATE_BOUND_BPS * FIXED_UNITS_PER_BPS >= 2.0 ** 63:
        limit = int(2.0 ** 63 / (RATE_BOUND_BPS * FIXED_UNITS_PER_BPS))
        raise ValueError(f"{name}: {n_subflows} sub-flows at up to {RATE_BOUND_BPS:g} bps "
                         f"overflow the int64 link loads (at most {limit})")


@functools.lru_cache(maxsize=None)
def check_cluster(library: str, device_index: int, C: int, n_links: int) -> None:
    """Raise unless the card can schedule a cluster of C CTAs of the kernel
    of ``csrc/<library>.cu`` with ``n_links`` link slots."""
    _i, _p = ctypes.c_int, ctypes.c_void_p
    fn = build.entry(library, f"{library}_max_clusters", (_i, _i, _p))
    count = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        build.raise_on(fn(C, n_links, ctypes.byref(count)), f"{library} occupancy")
    if count.value < 1:
        raise RuntimeError(f"{library}: the card cannot schedule a cluster of {C} CTAs "
                           f"with {n_links} links")


def device_index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


def segment_sum(vals: torch.Tensor, idx: torch.Tensor, size: int) -> torch.Tensor:
    """Per-simulation segment sum: vals, idx [B, M] -> [B, size]."""
    B = vals.shape[0]
    off = torch.arange(B, device=vals.device)[:, None] * size
    out = torch.zeros(B * size, dtype=vals.dtype, device=vals.device)
    out.index_add_(0, (idx.to(torch.int64) + off).reshape(-1), vals.reshape(-1))
    return out.view(B, size)


def fixed_point_index_add(idx: torch.Tensor, vals: torch.Tensor, size: int,
                          units: float) -> torch.Tensor:
    """sum of vals[i] over i with idx[i] == j, for j < size, as float32,
    in an order that does not matter: each value is rounded to a multiple of
    1 / ``units`` (a power of two), the integers are summed exactly in
    int64, and the sum is scaled back once.  The caller bounds
    ``len(vals) * max|vals| * units`` below 2**63."""
    q = torch.round(vals.reshape(-1).to(torch.float64) * units).to(torch.int64)
    out = torch.zeros(size, dtype=torch.int64, device=vals.device)
    out.index_add_(0, idx.reshape(-1).to(torch.int64), q)
    return (out.to(torch.float64) / units).to(torch.float32)


def link_segment_sum(vals: torch.Tensor, idx: torch.Tensor, size: int) -> torch.Tensor:
    """``segment_sum`` of rates in bit/s that repeats bit for bit on the
    card: CUDA tensors sum in the kernels' fixed point (``float`` atomics in
    ``index_add_`` would add in another order each run); CPU tensors, whose
    ``index_add_`` adds in order, keep the plain float sum."""
    if vals.device.type != "cuda":
        return segment_sum(vals, idx, size)
    check_fixed_point("link_segment_sum", vals[0].numel())
    B = vals.shape[0]
    off = torch.arange(B, device=vals.device)[:, None] * size
    return fixed_point_index_add(idx.to(torch.int64) + off, vals, B * size,
                                 FIXED_UNITS_PER_BPS).view(B, size)


def scale(load: torch.Tensor, capacity: torch.Tensor) -> torch.Tensor:
    """min(1, capacity / max(load, 1))."""
    return torch.clamp(capacity / torch.clamp(load, min=1.0), max=1.0)


def gather(vec: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """vec [B, L1], idx [B, M] -> vec[b, idx[b, m]]."""
    return torch.gather(vec, 1, idx.to(torch.int64))


def red_mark(new_queue: torch.Tensor, kmin: float, kmax: float, pmax: float) -> torch.Tensor:
    """RED/ECN marking ramp on the queue bytes."""
    ramp = (new_queue - kmin) / (kmax - kmin)
    return torch.where(new_queue < kmin, torch.zeros_like(new_queue),
                       torch.where(new_queue > kmax, torch.ones_like(new_queue),
                                   ramp * pmax))
