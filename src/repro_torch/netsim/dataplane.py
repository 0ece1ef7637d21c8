"""Fused switch dataplane: offered load -> queue -> RED/ECN mark, mirroring
``repro.netsim.dataplane`` with a leading batch dimension B on every
per-simulation tensor (the JAX package's ``vmap``).

  hop h arrivals are the UPSTREAM-scaled rates, so for h = 0..H-1:
      load_h[l]  = sum of sub-flow rates (scaled by hops < h) entering l
      scale_h[l] = min(1, cap[l] / load_h[l])
      r         <- r * scale_h[lid_h]
  arrival[l]   = sum_h load_h[l]
  queue[l]    <- clip(queue + (arrival - cap) * dt/8, 0, qmax) * queue_mask
  p_mark[l]    = RED ramp on queue (kmin/kmax/pmax)

Link vectors carry a sentinel slot ``n_links`` (capacity 1e30) onto which
absent (-1) hops land.  ``cascade_nic``, the NIC-tiered form, is what
both engines run; ``cascade``, the flat form, is the oracle it is checked
against.

Backends of both forms: the device of the tensors decides.  CUDA tensors
launch the hand-written kernel (``csrc/cascade_tiered.cu``,
``csrc/cascade_flat.cu``) and CPU tensors run its plain version;
``"auto"`` picks that, while ``"cuda"`` and ``"torch"`` only assert it, so
a configuration can never send CUDA tensors through the plain version.

DRILL's spray splits one sub-flow over all paths, so its 2-tier dataplane
(``drill_spray``) lives here too.  Its one-hot [n, L] products are plain
matrix products left to ``torch.matmul``; float32 products on the card
run in full float32 because TF32 stays off
(``torch.backends.cuda.matmul.allow_tf32`` is False by default, and this
package never sets it).
"""
from __future__ import annotations

import torch

from repro_torch.core import baselines, gbn
from repro_torch.kernels import cascade_tiered as ct, linkload as ll
from repro_torch.kernels.cascade_common import (
    fixed_point_index_add, link_segment_sum, red_mark,
)
from repro_torch.netsim.topology import Topology

BACKENDS = ("auto", "torch", "cuda")
INTENSITY_UNITS = 2.0 ** 32  # fixed-point units an expected marked packet


def resolve_backend(backend: str, device: torch.device) -> str:
    if backend not in BACKENDS:
        raise ValueError(f"dataplane backend {backend!r} not in {BACKENDS}")
    resolved = "cuda" if device.type == "cuda" else "torch"
    if backend not in ("auto", resolved):
        raise ValueError(f"dataplane backend {backend!r} does not run tensors "
                         f"on {device}: use 'auto' or {resolved!r}")
    return resolved


def take(vec: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """vec [B, M], idx [B, ...] -> vec[b, idx[b, ...]]."""
    B = vec.shape[0]
    flat = torch.gather(vec, 1, idx.reshape(B, -1).to(torch.int64))
    return flat.reshape(idx.shape)


def take_rows(mat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """mat [B, R, C], idx [B, n] -> mat[b, idx[b, n], :] as [B, n, C]."""
    C = mat.shape[-1]
    return torch.gather(mat, 1, idx.to(torch.int64)[..., None].expand(*idx.shape, C))


def cascade(links, rates, queue, capacity, queue_mask, *, n_links: int,
            kmin: float, kmax: float, pmax: float, dt: float, qmax_bytes: float,
            backend: str = "auto"):
    """Flat hop cascade, the oracle layout: links i32[B, ..., H] (-1 = absent),
    rates f32[B, ...], queue f32[B, n_links + 1], capacity and queue_mask
    f32[n_links + 1].  Returns (arrival, new_queue, p_mark) f32[B, n_links + 1]
    and thr f32[B, ...]."""
    backend = resolve_backend(backend, rates.device)
    B = rates.shape[0]
    hops = links.shape[-1]
    if queue.shape != (B, n_links + 1):
        raise ValueError(f"queue must be [B, n_links + 1] = {(B, n_links + 1)}, "
                         f"got {tuple(queue.shape)}")
    args = (links.reshape(B, -1, hops).to(torch.int32).contiguous(),
            rates.reshape(B, -1).contiguous(), queue.contiguous(),
            capacity.contiguous(), queue_mask.contiguous())
    kw = dict(kmin=kmin, kmax=kmax, pmax=pmax, dt=dt, qmax_bytes=qmax_bytes)
    if backend == "cuda":
        arrival, new_queue, p_mark, thr = ll.linkload_cascade(*args, **kw)
    else:
        arrival, new_queue, p_mark, thr = ll.linkload_cascade_torch(*args, **kw)
    return arrival, new_queue, p_mark, thr.reshape(rates.shape)


def cascade_nic(fab_links, tx_link, rx_link, rates, queue, capacity, queue_mask, *,
                n_links: int, kmin: float, kmax: float, pmax: float, dt: float,
                qmax_bytes: float, backend: str = "auto"):
    """NIC-tiered hop cascade: the N sub-flows of a flow share their host_tx
    and host_rx hops, so those two hops pre-reduce over N.

    fab_links i32[B, ..., N, Hf], tx_link/rx_link i32[B, ...],
    rates f32[B, ..., N], queue f32[B, n_links + 1], capacity and
    queue_mask f32[n_links + 1].  Returns (arrival, new_queue, p_mark)
    f32[B, n_links + 1] and thr f32[B, ..., N]."""
    backend = resolve_backend(backend, rates.device)
    B = rates.shape[0]
    N = rates.shape[-1]
    hf = fab_links.shape[-1]
    if queue.shape != (B, n_links + 1):
        raise ValueError(f"queue must be [B, n_links + 1] = {(B, n_links + 1)}, "
                         f"got {tuple(queue.shape)}")
    args = (fab_links.reshape(B, -1, N, hf).to(torch.int32).contiguous(),
            tx_link.reshape(B, -1).to(torch.int32).contiguous(),
            rx_link.reshape(B, -1).to(torch.int32).contiguous(),
            rates.reshape(B, -1, N).contiguous(), queue.contiguous(),
            capacity.contiguous(), queue_mask.contiguous())
    kw = dict(kmin=kmin, kmax=kmax, pmax=pmax, dt=dt, qmax_bytes=qmax_bytes)
    if backend == "cuda":
        arrival, new_queue, p_mark, thr = ct.cascade_tiered(*args, **kw)
    else:
        arrival, new_queue, p_mark, thr = ct.cascade_tiered_torch(*args, **kw)
    return arrival, new_queue, p_mark, thr.reshape(rates.shape)


def subflow_mark_probs(links, p_mark, n_links: int):
    """(p_sub, p_sub_fabric) f32[B, ...] of the flat layout links
    i32[B, ..., H]: the probability that a packet of the sub-flow is marked
    on any hop / on any fabric hop (hops 1..H-2)."""
    present = links >= 0
    lid = torch.where(present, links, torch.full_like(links, n_links))
    hop_mark = torch.where(present, take(p_mark, lid), 0.0)
    p_sub = 1.0 - torch.prod(1.0 - hop_mark, -1)
    p_sub_fabric = 1.0 - torch.prod(1.0 - hop_mark[..., 1:-1], -1)
    return p_sub, p_sub_fabric


def subflow_mark_probs_nic(fab_links, tx_link, rx_link, p_mark, n_links: int):
    """(p_sub, p_sub_fabric) f32[B, ..., N]: the probability that a packet
    of the sub-flow is marked on any hop / on any fabric hop (the marks the
    destination ToR mirrors back as Congestion Packets)."""
    present = fab_links >= 0
    lid = torch.where(present, fab_links, torch.full_like(fab_links, n_links))
    hop_mark = torch.where(present, take(p_mark, lid), 0.0)
    p_sub_fabric = 1.0 - torch.prod(1.0 - hop_mark, -1)
    keep = (1.0 - take(p_mark, tx_link)) * (1.0 - take(p_mark, rx_link))
    p_sub = 1.0 - keep[..., None] * (1.0 - p_sub_fabric)
    return p_sub, p_sub_fabric


def lossy_gbn_factor(fab_links, tx_link, rx_link, loss, *, n_links: int,
                     window_pkts: float) -> torch.Tensor:
    """Goodput multiplier f32[B, ..., N] for sub-flows that cross lossy
    links: each drop rewinds half a go-back-N window, so goodput deflates by
    ``gbn_goodput_factor(p_loss, W)`` while the offered rate keeps riding the
    wire (the engine applies it to the delivered throughput only).  A
    path's survival is the product of its hops' survivals, the host hops
    shared by the N sub-flows; absent (-1) fabric hops are loss-free.
    fab_links i32[B, ..., N, Hf], tx_link/rx_link i32[B, ...], loss
    f32[n_links + 1] shared by the batch."""
    present = fab_links >= 0
    lid = torch.where(present, fab_links, torch.full_like(fab_links, n_links))
    hop_loss = torch.where(present, loss[lid.to(torch.int64)], 0.0)
    surv_fab = torch.prod(1.0 - hop_loss, -1)
    surv_host = (1.0 - loss[tx_link.to(torch.int64)]) * (1.0 - loss[rx_link.to(torch.int64)])
    p_loss = 1.0 - surv_host[..., None] * surv_fab
    return gbn.gbn_goodput_factor(p_loss, window_pkts)


def reorder_gbn_factor(topo: Topology, pq, spray, rc0, reorder, *, mtu_bytes: float,
                       jitter_mtus: float, window_pkts: float, capacity=None):
    """Go-back-N byte amplification f32[B, n] (>= 1) of flowcell-split flows.

    pq f32[B, n, P] per-path queue bytes (``path_queue_2tier``); spray
    i32[B, n] the paths a flow's parent chunk straddles; rc0 f32[B, n] its
    offered rate; reorder the f32 scalar tensor budget in packets.  A chunk
    over k of P paths sees (k - 1) / (P - 1) of the inter-path delay spread
    (floored by the mean queue's jitter, as DRILL's); the NIC re-sequences
    ``reorder`` packets' worth of it for free, and each out-of-order packet
    past that rewinds half a window: ``1 + p_ooo * window / 2``.  Exactly 1
    where ``spray <= 1`` (``torch.where``, no product that could round)."""
    P = topo.n_paths
    cap = topo.capacity if capacity is None else capacity
    up_cap = torch.clamp(cap[0], min=1.0)  # uplink block starts at 0 (2-tier)
    d_path = pq * 8.0 / up_cap  # [B, n, P] seconds
    full_spread = d_path.amax(-1) - d_path.amin(-1)
    k = torch.clamp(spray.to(torch.float32), 1.0, float(P))
    frac = (k - 1.0) / float(max(P - 1, 1))
    jitter_bytes = torch.clamp(0.5 * pq.mean(-1), max=jitter_mtus * mtu_bytes)
    jitter = jitter_bytes * 8.0 / up_cap
    skew = torch.maximum(full_spread, jitter) * frac
    budget_s = reorder * mtu_bytes * 8.0 / torch.clamp(rc0, min=1.0)
    p_ooo = gbn.ooo_probability(torch.clamp(skew - budget_s, min=0.0), rc0, mtu_bytes)
    return torch.where(spray > 1, 1.0 + p_ooo * (window_pkts / 2.0), 1.0)


def queue_mask_for(topo: Topology) -> torch.Tensor:
    """1.0 on links that queue and ECN-mark, 0.0 on host_tx (NIC-internal
    backlog, no ECN there) and on the sentinel slot."""
    nl = topo.n_links
    h0 = nl - 2 * topo.n_hosts
    mask = torch.ones((nl + 1,), dtype=torch.float32, device=topo.device)
    mask[h0: h0 + topo.n_hosts] = 0.0
    mask[nl] = 0.0
    return mask


def integrate_queue(queue, arrival, capacity, queue_mask, dparams, *, dt: float,
                    qmax_bytes: float, n_links: int):
    """Queue integration + RED/ECN marks for dataplanes that compute their
    own arrival vector (DRILL's spray); queue, arrival f32[B, n_links + 1]."""
    new_queue = torch.clamp(queue + (arrival - capacity) * dt / 8.0, 0.0,
                            qmax_bytes) * queue_mask
    p_mark = red_mark(new_queue, dparams.kmin_bytes, dparams.kmax_bytes, dparams.pmax)
    p_mark[:, n_links] = 0.0
    return new_queue, p_mark


def queue_fast_forward(queue, arrival, capacity, queue_mask, *, dt: float, n_steps: int,
                       qmax_bytes: float, n_links: int):
    """``n_steps`` queue steps in closed form under a constant arrival
    vector: ``q <- clip(q + delta, 0, qmax) * mask`` with a constant delta is
    monotone, so step m is ``clip(q0 + m * delta, 0, qmax) * mask``.
    queue, arrival f32[B, n_links + 1]; capacity, queue_mask f32[n_links + 1].
    Returns (q_final f32[B, n_links + 1], max_queue f32[B, n_steps]), entry m
    of the second the largest real-link queue after m + 1 steps (the
    per-step ``max_queue`` output)."""
    delta = (arrival - capacity) * (dt / 8.0)
    m = torch.arange(1, n_steps + 1, dtype=torch.float32, device=queue.device)[:, None]
    traj = torch.clamp(queue[:, None, :] + m * delta[:, None, :], 0.0, qmax_bytes)
    traj = traj * queue_mask
    return traj[:, -1], traj[:, :, :n_links].amax(-1)


def path_queue_2tier(topo: Topology, queue, src_leaf, dst_leaf) -> torch.Tensor:
    """Queue bytes along each (up, down) path for every flow: f32[B, n, P]."""
    S, L = topo.n_paths, topo.n_leaf
    B = queue.shape[0]
    q_up = queue[:, 0: L * S].reshape(B, L, S)
    q_dn = queue[:, L * S: 2 * L * S].reshape(B, S, L).transpose(1, 2)
    return take_rows(q_up, src_leaf) + take_rows(q_dn, dst_leaf)


def congestion_intensity(cell, marked, n_cells: int, *, max_pkts: float):
    """SeqBalance's congestion intensity, f32[n_cells]: the sum of ``marked``
    (expected marked packets a sub-flow this step) over the entries whose
    ``cell`` (source ToR x path, flattened) is j.  Both engines call it
    before the ``>= cong_threshold_pkts`` test.  On the card the sum is
    taken in int64 fixed point (2**-32 packets a unit), so that the test
    reads the same sum run after run (``float`` atomics in ``index_add_``
    would add in another order each time); on the CPU ``index_add_`` adds
    in order, as the JAX package's segment sum does.  ``max_pkts`` bounds
    one entry (a sub-flow's packets a step at line rate); the fixed point
    holds while ``marked.numel() * max_pkts < 2**31``."""
    if marked.device.type != "cuda":
        out = torch.zeros(n_cells, dtype=torch.float32, device=marked.device)
        return out.index_add_(0, cell.reshape(-1), marked.reshape(-1))
    if marked.numel() * max_pkts * INTENSITY_UNITS >= 2.0 ** 63:
        raise ValueError(f"congestion_intensity: {marked.numel()} entries of up to "
                         f"{max_pkts:g} packets overflow the int64 fixed point")
    return fixed_point_index_add(cell, marked, n_cells, INTENSITY_UNITS)


def drill_spray(topo: Topology, queue, rc0, src, dst, src_leaf, dst_leaf, active0,
                drill_q0: float, capacity=None):
    """DRILL's per-packet spray on a 2-tier Clos: inverse-queue weights over
    all paths, cascaded host_tx -> uplink -> downlink -> host_rx.

    queue f32[B, n_links + 1]; rc0, src, dst, src_leaf, dst_leaf [B, n];
    active0 bool[B, n, 1].  Returns (arrival f32[B, n_links + 1], thr
    f32[B, n] before the go-back-N penalty, w f32[B, n, P], pq f32[B, n, P])."""
    cap = topo.capacity if capacity is None else capacity
    nl = topo.n_links
    H = topo.n_hosts
    L_, S_ = topo.n_leaf, topo.n_paths
    h0 = nl - 2 * H
    B = queue.shape[0]
    dev = queue.device
    pq = path_queue_2tier(topo, queue, src_leaf, dst_leaf)  # [B, n, P]
    w = baselines.drill_weights(pq, drill_q0) * active0
    leaves = torch.arange(L_, device=dev)
    oh_s = (src_leaf.to(torch.int64)[..., None] == leaves).to(torch.float32)  # [B, n, L]
    oh_d = (dst_leaf.to(torch.int64)[..., None] == leaves).to(torch.float32)
    arrival = torch.zeros((B, nl + 1), dtype=torch.float32, device=dev)
    # hop 0: host NIC
    tx_load = link_segment_sum(rc0, src, H)  # [B, H]
    arrival[:, h0: h0 + H] = tx_load
    s_tx = torch.clamp(cap[h0 + src.to(torch.int64)]
                       / torch.clamp(take(tx_load, src), min=1.0), max=1.0)
    r0 = rc0 * s_tx
    # hop 1: uplinks (per-path split)
    r0w = r0[..., None] * w  # [B, n, P]
    up_load = torch.matmul(oh_s.transpose(1, 2), r0w)  # [B, L, P]
    arrival[:, 0: L_ * S_] = up_load.reshape(B, -1)
    cap_up = cap[0: L_ * S_].reshape(L_, S_)
    s_up = torch.clamp(cap_up / torch.clamp(up_load, min=1.0), max=1.0)
    r1 = r0w * torch.matmul(oh_s, s_up)  # [B, n, P]
    # hop 2: downlinks
    dn_load = torch.matmul(oh_d.transpose(1, 2), r1)  # [B, L, P] by dst leaf
    arrival[:, L_ * S_: 2 * L_ * S_] = dn_load.transpose(1, 2).reshape(B, -1)
    cap_dn = cap[L_ * S_: 2 * L_ * S_].reshape(S_, L_)
    s_dn = torch.clamp(cap_dn.T / torch.clamp(dn_load, min=1.0), max=1.0)
    r2 = r1 * torch.matmul(oh_d, s_dn)
    # hop 3: receiver NIC
    r2sum = r2.sum(-1)
    rx_load = link_segment_sum(r2sum, dst, H)
    arrival[:, h0 + H: h0 + 2 * H] = rx_load
    s_rx = torch.clamp(cap[h0 + H + dst.to(torch.int64)]
                       / torch.clamp(take(rx_load, dst), min=1.0), max=1.0)
    thr = r2sum * s_rx
    return arrival, thr, w, pq


def drill_mark_probs(topo: Topology, p_mark, w, src_leaf, dst_leaf, dst):
    """(p_sub, p_sub_fabric) f32[B, n, 1] for DRILL's weighted spray."""
    nl = topo.n_links
    L_, S_ = topo.n_leaf, topo.n_paths
    h0 = nl - 2 * topo.n_hosts
    B = p_mark.shape[0]
    pm_up = take_rows(p_mark[:, 0: L_ * S_].reshape(B, L_, S_), src_leaf)
    pm_dn = take_rows(p_mark[:, L_ * S_: 2 * L_ * S_].reshape(B, S_, L_).transpose(1, 2),
                      dst_leaf)
    pm_fab = 1.0 - (1.0 - pm_up) * (1.0 - pm_dn)  # [B, n, P]
    p_sub_fabric = (w * pm_fab).sum(-1, keepdim=True)
    p_host = take(p_mark, h0 + topo.n_hosts + dst.to(torch.int64))
    p_sub = 1.0 - (1.0 - p_sub_fabric) * (1.0 - p_host[..., None])
    return p_sub, p_sub_fabric


def drill_gbn_factor(topo: Topology, pq, w, rc0, *, mtu_bytes: float,
                     jitter_mtus: float, window_pkts: float, capacity=None):
    """Go-back-N goodput multiplier f32[B, n] for DRILL's spray: the delay
    spread over used paths, floored by the jitter of the mean queue."""
    P = topo.n_paths
    cap = topo.capacity if capacity is None else capacity
    up_cap = torch.clamp(cap[0], min=1.0)  # uplink block starts at 0 (2-tier)
    d_path = pq * 8.0 / up_cap  # [B, n, P] seconds
    used = w > (0.5 / P)
    dmax = torch.where(used, d_path, -torch.inf).amax(-1)
    dmin = torch.where(used, d_path, torch.inf).amin(-1)
    spread = torch.where(torch.isfinite(dmax) & torch.isfinite(dmin), dmax - dmin, 0.0)
    mean_q = (torch.where(used, pq, 0.0).sum(-1)
              / torch.clamp(used.sum(-1), min=1))
    jitter_bytes = torch.clamp(0.5 * mean_q, max=jitter_mtus * mtu_bytes)
    jitter = jitter_bytes * 8.0 / up_cap
    p_ooo = gbn.ooo_probability(torch.maximum(spread, jitter), rc0, mtu_bytes)
    return gbn.gbn_goodput_factor(p_ooo, window_pkts)
