"""Active-window compacted fluid simulator, mirroring
``repro.netsim.compact``.

Flows are sorted by arrival and a compact ``[W, N]`` working set of slots
carries the flows in flight:

  * admit   — each step, flows whose arrival has passed are gathered into
    free slots in arrival order, at most A per step, and everything the
    per-step physics needs about a flow is snapshotted into the
    slot-indexed ``SlotCache``;
  * cascade — offered rates -> NIC-tiered hop cascade -> queues and ECN
    marks (``dataplane.cascade_nic``, the CUDA kernel on the card);
  * dcqcn   — the rate-control step;
  * finish  — transfer progress, bitmap CQEs, finish times scattered into
    the ``[F]`` vector, freed slots, and the SeqBalance Congestion Table.

The state carries a leading batch dimension B: the reference runs a
``vmap`` of one simulation, this port writes the batch out.  The
reference's ``lax.scan`` becomes a Python loop of K-step chunks; the
early-exit test runs once per chunk and is the loop's only host
synchronisation.  Admission runs every step (the reference's ``lax.cond``
gate only saves time; results are identical without it).

If the window W is too small, arrivals wait at the NIC and admit as slots
free; ``spill_steps`` counts the steps where that happened.

Three traced operands of the reference ride along: ``capacity`` (a
vector, or a wall-clock schedule of rows stepped every ``cap_seg_steps``
steps) in place of the topology's; ``loss``, per-link loss rates that
deflate delivered throughput by the go-back-N factor; and ``reorder``, the
NIC's reordering budget, which charges flowcell-split flows (the trace's
``spray`` column) their go-back-N cost.  With ``SimConfig.adaptive`` each
chunk boundary also checks for quiescence and advances quiet simulations
a whole macro-step in closed form, and with ``record`` the flight
recorder (``repro_torch.obs.recorder``) writes one summary row per chunk
(``run_core``).
"""
from __future__ import annotations

import threading
from typing import NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch import resolve_device
from repro_torch.core import baselines, congestion_table as ctab, hashing, routing, shaper
from repro_torch.netsim import dataplane, dcqcn as dcqcn_mod
from repro_torch.netsim.engine import (
    DONE_EPS_BYTES, SimConfig, StepOutputs, check_reorder, flow_constants, line_rate_of,
)
from repro_torch.netsim.topology import Topology
from repro_torch.netsim.workloads import Trace


class SlotCache(NamedTuple):
    """Admit-time route cache, [B, W, ...].  Stale entries of freed slots
    are harmless: their offered rate is 0."""

    tx: torch.Tensor  # i32[B, W] host_tx link id
    rx: torch.Tensor  # i32[B, W] host_rx link id
    fab: torch.Tensor  # i32[B, W, N, Hf] fabric link ids (pinned-path schemes)
    sleaf: torch.Tensor  # i32[B, W]
    dleaf: torch.Tensor  # i32[B, W]
    salt: torch.Tensor  # u32 in int64 [B, W, N] DCQCN mark-draw salt
    fid: torch.Tensor  # u32 in int64 [B, W] flow id (flowlet reroute rng)
    src: torch.Tensor  # i32[B, W] source host (DRILL spray)
    dst: torch.Tensor  # i32[B, W]
    spray: torch.Tensor  # i32[B, W] paths the flow's chunk straddles (reorder cost)


class CompactState(NamedTuple):
    slot_fid: torch.Tensor  # i64[B, W] sorted-flow index; F_pad = empty
    remaining: torch.Tensor  # f32[B, W, N]
    path: torch.Tensor  # i32[B, W, N]
    sub_done: torch.Tensor  # bool[B, W, N]
    cc: dcqcn_mod.DCQCNState  # [B, W, N]
    cqe_bitmap: torch.Tensor  # u32 in int64 [B, W]
    admitted: torch.Tensor  # i64[B] flows admitted so far
    finish: torch.Tensor  # f32[B, F_pad] (+inf until CQE), sorted order
    table: ctab.CongestionTable  # [B, n_leaf, n_paths]
    queue: torch.Tensor  # f32[B, n_links + 1]
    cnp_pkts: torch.Tensor  # f32[B]
    spill_steps: torch.Tensor  # i64[B] steps where an arrived flow found no slot
    step: torch.Tensor  # i64[B]
    ff_steps: torch.Tensor  # i64[B] steps advanced by the quiescence fast-forward
    cache: SlotCache


class CompactResult(NamedTuple):
    """Host-side result of one simulation."""

    finish: np.ndarray  # f32[F] original trace order
    cnp_pkts: np.ndarray  # f32 scalar
    spill_steps: int
    window_slots: int = 0  # W the (final) run used
    steps: int = 0  # dt steps the run executed before its early exit
    ff_steps: int = 0  # of those, the steps covered by the closed-form fast-forward
    ring: object = None  # obs.recorder.RingState of this simulation (B = 1) when recording


def max_concurrency_bound(sizes, arrivals, valid, line_rate: float, *,
                          slack_slowdown: float = 12.0, slack_s: float = 150e-6,
                          safety: float = 1.2) -> int:
    """Estimated bound on concurrently-active flows: every flow lives
    ``slack_slowdown`` x its line-rate serialization plus ``slack_s``; take
    the max interval overlap (a heuristic; spill reports when it fails)."""
    a = np.asarray(arrivals, np.float64)[np.asarray(valid, bool)]
    s = np.asarray(sizes, np.float64)[np.asarray(valid, bool)]
    if a.size == 0:
        return 64
    order = np.argsort(a, kind="stable")
    a = a[order]
    end = np.sort(a + s[order] * 8.0 / line_rate * slack_slowdown + slack_s)
    started = np.arange(1, a.size + 1)
    ended = np.searchsorted(end, a, side="left")
    conc = int((started - ended).max())
    return int(conc * safety) + 64


def max_admits_per_step(arrivals, valid, dt: float) -> int:
    """Exact peak number of arrivals in any one ``dt`` step (the admission
    lane width A)."""
    a = np.asarray(arrivals, np.float64)[np.asarray(valid, bool)]
    if a.size == 0:
        return 1
    steps = np.ceil(a / dt).astype(np.int64)
    return int(np.bincount(steps - steps.min()).max())


def plan_single_window(topo: Topology, cfg: SimConfig, arrays: tuple,
                       F_pad: int) -> tuple[int, int]:
    """(W, A) for a single sorted trace: the 128-bucketed concurrency bound
    (floored at min(128, F_pad)) and the 32-bucketed exact-peak admission
    lane."""
    bound = max_concurrency_bound(arrays[0], arrays[1], arrays[5], line_rate_of(topo))
    W = int(min(((bound + 127) // 128) * 128, F_pad))
    W = max(W, min(128, F_pad))
    A = min(((max_admits_per_step(arrays[1], arrays[5], cfg.dt) + 31) // 32) * 32, F_pad)
    return W, A


def plan_chunks(cfg: SimConfig, n_steps: int) -> tuple[int, int, int]:
    """(K, n_chunks, tail): chunk length (a multiple of the uplink sample
    window, capped at the horizon, preferring a divisor of the horizon),
    full chunks, and leftover steps."""
    s = cfg.uplink_sample_every
    K0 = max(1, cfg.chunk_steps // s) * s
    K0 = min(K0, max(n_steps, 1))
    for k in range(K0, 0, -1):
        if k % s == 0 and n_steps % k == 0:
            return k, n_steps // k, 0
    return K0, n_steps // K0, n_steps % K0


def event_grid(cfg: SimConfig, n_steps: int, arrivals=None, valid=None,
               cap_seg_steps: int = 0) -> np.ndarray:
    """The step boundaries that no macro-step may cross, host-side: flow
    arrival steps, capacity-segment edges and uplink sample-window edges.
    The adaptive engine keeps to it by construction: macro-steps are whole
    chunks (K a multiple of the sample window, ``plan_chunks``), and the
    quiescence check refuses a span with an arrival or a segment edge."""
    edges = [np.array([0, n_steps], np.int64)]
    if arrivals is not None:
        a = np.asarray(arrivals, np.float64)
        if valid is not None:
            a = a[np.asarray(valid, bool)]
        a = a[np.isfinite(a)]
        steps = np.ceil(a / cfg.dt).astype(np.int64)
        edges.append(steps[(steps >= 0) & (steps <= n_steps)])
    if cap_seg_steps and cap_seg_steps > 0:
        edges.append(np.arange(0, n_steps + 1, cap_seg_steps, dtype=np.int64))
    if cfg.uplink_sample_every > 1:
        edges.append(np.arange(0, n_steps + 1, cfg.uplink_sample_every, dtype=np.int64))
    return np.unique(np.concatenate(edges))


def sort_trace(trace: Trace) -> tuple[tuple, np.ndarray, int]:
    """Sort a trace by arrival (invalid flows last at +inf).  Returns
    (sorted arrays tuple, inverse permutation, n_flows); the arrays are
    (sizes, arrivals, src, dst, fid, valid, spray)."""
    valid = np.asarray(trace.valid, bool)
    arr = np.asarray(trace.arrivals, np.float32).copy()
    arr[~valid] = np.inf
    order = np.argsort(arr, kind="stable")
    inv = np.empty_like(order)
    inv[order] = np.arange(order.size)
    arrays = (
        np.asarray(trace.sizes, np.float32)[order],
        arr[order],
        np.asarray(trace.src, np.int32)[order],
        np.asarray(trace.dst, np.int32)[order],
        np.asarray(trace.flow_id, np.uint32)[order],
        valid[order],
        np.asarray(trace.spray, np.int32)[order],
    )
    return arrays, inv, order.size


def pad_trace_arrays(arrays: tuple, F_pad: int) -> tuple:
    """The sorted arrays padded to F_pad flows (invalid, spray 1)."""
    sizes, arr, src, dst, fid, valid, spray = arrays
    pad = F_pad - sizes.shape[0]
    if pad < 0:
        raise ValueError(f"{sizes.shape[0]} flows do not fit F_pad={F_pad}")
    if pad == 0:
        return arrays
    return (
        np.concatenate([sizes, np.ones(pad, np.float32)]),
        np.concatenate([arr, np.full(pad, np.inf, np.float32)]),
        np.concatenate([src, np.zeros(pad, np.int32)]),
        np.concatenate([dst, np.zeros(pad, np.int32)]),
        np.concatenate([fid, np.zeros(pad, np.uint32)]),
        np.concatenate([valid, np.zeros(pad, bool)]),
        np.concatenate([spray, np.ones(pad, np.int32)]),
    )


def trace_tensors(stacked: tuple, device) -> tuple:
    """Stacked [B, F_pad] numpy trace arrays -> tensors on ``device`` (flow
    ids widened to int64, as every uint32 in this package); all seven
    columns, ``spray`` the last."""
    sizes, arr, src, dst, fid, valid, spray = stacked
    return (torch.as_tensor(sizes, dtype=torch.float32, device=device),
            torch.as_tensor(arr, dtype=torch.float32, device=device).contiguous(),
            torch.as_tensor(src, dtype=torch.int32, device=device),
            torch.as_tensor(dst, dtype=torch.int32, device=device),
            torch.as_tensor(np.asarray(fid).astype(np.int64), device=device),
            torch.as_tensor(valid, dtype=torch.bool, device=device),
            torch.as_tensor(spray, dtype=torch.int32, device=device))


def line_rate_for(topo: Topology, capacity=None) -> float:
    """The DCQCN line rate: host_tx[0]'s bandwidth in ``capacity`` (row 0
    of a schedule), or in the topology's when it is None."""
    if capacity is None:
        return line_rate_of(topo)
    cap0 = capacity[0] if capacity.dim() == 2 else capacity
    return float(cap0[topo.n_links - 2 * topo.n_hosts])


def init_compact_state(topo: Topology, cfg: SimConfig, W: int, F_pad: int,
                       B: int = 1, capacity=None) -> CompactState:
    """Fresh all-slots-empty state on the topology's device.  ``capacity``
    (the traced operand of ``build_compact_sim``) sets the line rate the
    DCQCN state starts at."""
    dev = topo.device
    N = cfg.n_sub
    hf = topo.n_fabric_hops

    def zi(*shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    cache = SlotCache(
        tx=zi(B, W), rx=zi(B, W), fab=zi(B, W, N, hf), sleaf=zi(B, W), dleaf=zi(B, W),
        salt=zi(B, W, N, dtype=torch.int64), fid=zi(B, W, dtype=torch.int64),
        src=zi(B, W), dst=zi(B, W), spray=torch.ones((B, W), dtype=torch.int32, device=dev),
    )
    return CompactState(
        slot_fid=torch.full((B, W), F_pad, dtype=torch.int64, device=dev),
        remaining=torch.zeros((B, W, N), dtype=torch.float32, device=dev),
        path=torch.full((B, W, N), -1, dtype=torch.int32, device=dev),
        sub_done=torch.zeros((B, W, N), dtype=torch.bool, device=dev),
        cc=dcqcn_mod.init_state((B, W, N), line_rate_for(topo, capacity), dev),
        cqe_bitmap=zi(B, W, dtype=torch.int64),
        admitted=zi(B, dtype=torch.int64),
        finish=torch.full((B, F_pad), torch.inf, dtype=torch.float32, device=dev),
        table=ctab.CongestionTable.create(topo.n_leaf, topo.n_paths, dev, (B,)),
        queue=torch.zeros((B, topo.n_links + 1), dtype=torch.float32, device=dev),
        cnp_pkts=torch.zeros((B,), dtype=torch.float32, device=dev),
        spill_steps=zi(B, dtype=torch.int64),
        step=zi(B, dtype=torch.int64),
        ff_steps=zi(B, dtype=torch.int64),
        cache=cache,
    )


def build_compact_sim(topo: Topology, cfg: SimConfig, trace_arrays: tuple, W: int,
                      F_pad: int, A: int, capacity=None, loss=None, cap_seg_steps: int = 0,
                      reorder=None):
    """trace_arrays = (sizes, arrivals, src, dst, fid, valid, spray),
    tensors [B, F_pad] on the topology's device, each row SORTED by arrival
    (invalid flows last, arrival = +inf).

    ``capacity`` (f32[n_links + 1] on the topology's device, sentinel slot
    included) takes the place of ``topo.capacity``; a schedule
    f32[K, n_links + 1] feeds row ``min(step // cap_seg_steps, K - 1)`` to
    each step (the B simulations step in lockstep, so they share it).  The
    line rate is host_tx[0]'s in row 0.  ``loss`` (f32[n_links + 1])
    multiplies delivered throughput by ``dataplane.lossy_gbn_factor`` after
    the cascade, while the offered load stays at the DCQCN rate; it needs
    ``capacity`` and refuses DRILL, whose spray pins no hops.
    ``reorder`` (an f32 scalar tensor on the device, packets) divides
    delivered throughput by ``dataplane.reorder_gbn_factor`` of the
    queues along each path (``path_queue_2tier``) and the step's capacity,
    wherever a flow's spray is above 1; it refuses DRILL and fabrics that
    are not 2-tier.  ``capacity=None`` runs the
    program without any of the three operands, ``reorder=None`` without the
    reordering cost.

    Returns (init_state, step_fn, phases): ``step_fn(state) -> (state,
    StepOutputs)`` advances all B simulations by one ``dt`` through the
    four step closures of ``phases``, ``admit``, ``cascade``, ``dcqcn`` and
    ``finish`` (``netsim/profile.py`` times each alone); ``phases`` also
    holds the adaptive engine's ``quiesce`` and ``fast_forward``."""
    dev = topo.device
    sizes, arrivals, src, dst, fid, valid, spray = trace_arrays
    B = sizes.shape[0]
    N = cfg.n_sub
    P = topo.n_paths
    nl = topo.n_links
    if cfg.scheme in ("conga", "drill", "flowlet_timeout") and topo.kind != "leaf_spine":
        raise ValueError(f"{cfg.scheme} is 2-tier only (paper §IV.B)")
    if loss is not None and capacity is None:
        raise ValueError("the loss operand needs an explicit capacity operand")
    if loss is not None and cfg.scheme == "drill":
        raise ValueError("lossy links with DRILL's spray are not modelled (no pinned hops)")
    if reorder is not None:
        check_reorder(topo, cfg)
    fc = flow_constants(topo, cfg, sizes, src, dst, fid)
    line_rate = line_rate_for(topo, capacity)
    cap = topo.capacity if capacity is None else capacity
    if cap.dim() == 2:
        seg, n_rows = max(int(cap_seg_steps), 1), cap.shape[0]

        def cap_of(state):
            """The schedule's row for the (shared) step, on the device."""
            row = torch.clamp(state.step[:1] // seg, max=n_rows - 1)
            return cap.index_select(0, row)[0]
    else:
        def cap_of(state):
            return cap
    qmask = dataplane.queue_mask_for(topo)
    dp = cfg.dcqcn
    full_cqe = (1 << N) - 1
    # schemes whose sub-flow paths are pinned at admission carry their
    # fabric link ids in the SlotCache; flowlet schemes may reroute any
    # slot any step, so their (N=1) fabric row is rebuilt from leaf ids
    cached_fab = cfg.scheme in ("seqbalance", "ecmp")
    flowlet = cfg.scheme in ("letflow", "conga", "flowlet_timeout")
    ranks = torch.arange(A, dtype=torch.int64, device=dev)
    slots = torch.arange(W, dtype=torch.int64, device=dev).expand(B, W)
    b_lane = torch.arange(B, device=dev)[:, None].expand(B, A)
    uplink_ids = torch.as_tensor(topo.uplink_ids.astype(np.int64), device=dev)
    # admission's slot-reset values as device scalars, made once (a fresh
    # torch.tensor per step would be a host-to-device copy per step)
    false_, zero_i64 = (torch.tensor(v, device=dev) for v in (False, 0))
    cc0 = tuple(torch.tensor(v, dtype=torch.float32, device=dev)
                for v in (line_rate, line_rate, 1.0, 1.0, 0.0, 0.0))  # dcqcn.init_state

    def init_state() -> CompactState:
        return init_compact_state(topo, cfg, W, F_pad, B, capacity)

    def at_rank(x, rank_fid):
        """Gather per-flow constants [B, F_pad, ...] at the lane's flows."""
        idx = rank_fid.reshape(B, A, *([1] * (x.dim() - 2))).expand(B, A, *x.shape[2:])
        return torch.gather(x, 1, idx)

    def set_rows(old, slot_of_rank, new):
        """old[b, slot_of_rank[b, k]] = new[b, k]; slot W drops the write."""
        pad = torch.cat([old, old[:, :1]], 1)
        pad[b_lane, slot_of_rank] = new
        return pad[:, :W].contiguous()

    def admission(state: CompactState) -> CompactState:
        t = state.step.to(torch.float32) * cfg.dt  # [B]
        occ_prev = state.slot_fid < F_pad
        n_arr = torch.searchsorted(arrivals, t[:, None], right=True)[:, 0]
        backlog = n_arr - state.admitted
        free = ~occ_prev
        free_rank = torch.cumsum(free.to(torch.int64), 1) - 1  # [B, W]
        m = torch.clamp(torch.minimum(backlog, free.sum(1)), max=A)
        newly = free & (free_rank < m[:, None])
        slot_fid = torch.where(newly, state.admitted[:, None] + free_rank, state.slot_fid)

        # admission lane: rank k in [0, A) takes flow admitted+k and lands
        # in the k-th free slot (slot W for ranks beyond m: dropped)
        rank_fid = torch.clamp(state.admitted[:, None] + ranks, max=F_pad - 1)  # [B, A]
        slot_of_rank = torch.full((B, A + 1), W, dtype=torch.int64, device=dev)
        slot_of_rank.scatter_(1, torch.where(newly, free_rank, A), slots)
        slot_of_rank = slot_of_rank[:, :A]

        src_a, dst_a = at_rank(src, rank_fid), at_rank(dst, rank_fid)
        sleaf_a, dleaf_a = at_rank(fc.src_leaf, rank_fid), at_rank(fc.dst_leaf, rank_fid)
        tx_a, rx_a = topo.nic_links(src_a, dst_a)
        ca = state.cache
        cache = ca._replace(
            tx=set_rows(ca.tx, slot_of_rank, tx_a),
            rx=set_rows(ca.rx, slot_of_rank, rx_a),
            sleaf=set_rows(ca.sleaf, slot_of_rank, sleaf_a),
            dleaf=set_rows(ca.dleaf, slot_of_rank, dleaf_a),
            salt=set_rows(ca.salt, slot_of_rank, at_rank(fc.sub_salt, rank_fid)),
            fid=set_rows(ca.fid, slot_of_rank, at_rank(fid, rank_fid)),
            src=set_rows(ca.src, slot_of_rank, src_a),
            dst=set_rows(ca.dst, slot_of_rank, dst_a),
            spray=set_rows(ca.spray, slot_of_rank, at_rank(spray, rank_fid)),
        )
        remaining = set_rows(state.remaining, slot_of_rank, at_rank(fc.sub_sizes, rank_fid))
        sub_done = set_rows(state.sub_done, slot_of_rank, false_)
        cqe_bitmap = set_rows(state.cqe_bitmap, slot_of_rank, zero_i64)
        cc = dcqcn_mod.DCQCNState(*(set_rows(old, slot_of_rank, v)
                                    for old, v in zip(state.cc, cc0)))

        # NEW-flow path placement on the [A] admission lane
        if cfg.scheme == "seqbalance":
            inact = ctab.inactive_matrix(state.table, t[:, None, None])  # [B, L, P]
            stale = inact.sum(-1, keepdim=True) > (P // 2)
            inact = inact & ~stale
            rows = dataplane.take_rows(inact, sleaf_a)[:, :, None, :].expand(B, A, N, P)
            s5_a = tuple(at_rank(a, rank_fid) for a in fc.s5)  # each [B, A, N]
            p_new = routing.select_paths(*s5_a, rows, P)
        elif cfg.scheme in ("ecmp", "letflow", "conga", "flowlet_timeout"):
            f5_a = tuple(at_rank(a, rank_fid) for a in fc.f5)  # each [B, A]
            p_new = routing.ecmp_paths(*f5_a, P)[..., None]
        else:  # drill: nominal path 0; the real split is the spray weights
            p_new = torch.zeros((B, A, 1), dtype=torch.int32, device=dev)
        path = set_rows(state.path, slot_of_rank, p_new)
        if cached_fab:
            fab_a = topo.fabric_links(sleaf_a[..., None], dleaf_a[..., None], p_new)
            cache = cache._replace(fab=set_rows(cache.fab, slot_of_rank, fab_a))

        return state._replace(
            slot_fid=slot_fid, remaining=remaining, path=path, sub_done=sub_done,
            cc=cc, cqe_bitmap=cqe_bitmap, admitted=state.admitted + m,
            spill_steps=state.spill_steps + (backlog > m).to(torch.int64),
            cache=cache,
        )

    def admit_phase(state: CompactState) -> CompactState:
        """Admission plus the flowlet schemes' per-step reroute of the
        slots that were occupied before admission."""
        occ_prev = state.slot_fid < F_pad
        st = admission(state)
        if flowlet:
            rng = hashing.fmix32(st.cache.fid ^ hashing.mul32(st.step[:, None], 0x85EBCA77))
            gap = baselines.flowlet_gap_occurs(st.cc.rc[..., 0], dp.mtu_bytes,
                                               cfg.flowlet_timeout)
            if cfg.scheme == "letflow":
                p_re = baselines.letflow_paths(st.path[..., 0], gap, rng, P)
            elif cfg.scheme == "flowlet_timeout":
                # WCMP re-draw over the step's uplink capacities (a traced
                # schedule counts): fat uplinks take more flowlets
                cap_up = cap_of(st)[: topo.n_leaf * P].reshape(topo.n_leaf, P)
                w_leaf = baselines.wcmp_weights(cap_up)  # [L, P]
                p_re = baselines.flowlet_wcmp_paths(st.path[..., 0], gap, rng,
                                                    w_leaf[st.cache.sleaf.to(torch.int64)])
            else:
                pq = dataplane.path_queue_2tier(topo, st.queue, st.cache.sleaf,
                                                st.cache.dleaf)
                p_re = baselines.conga_paths(st.path[..., 0], gap, pq)
            path = torch.where(occ_prev, p_re, st.path[..., 0])[..., None]
            st = st._replace(path=path)
        return st

    def cascade_phase(state: CompactState):
        """Offered rates -> hop cascade -> queue/ECN marks.  Returns
        (arrival, new_queue, thr, p_sub, p_sub_fabric, rc, active)."""
        occupied = state.slot_fid < F_pad
        active = occupied[..., None] & ~state.sub_done
        rc = torch.where(active, torch.minimum(state.cc.rc, state.remaining * 8.0 / cfg.dt),
                         0.0)
        ca = state.cache
        capv = cap_of(state)
        if cfg.scheme == "drill":
            arrival, thr, w_spray, pq = dataplane.drill_spray(
                topo, state.queue, rc[..., 0], ca.src, ca.dst, ca.sleaf, ca.dleaf,
                active[..., 0:1], cfg.drill_q0, capacity=capv)
            new_queue, p_mark = dataplane.integrate_queue(
                state.queue, arrival, capv, qmask, dp, dt=cfg.dt,
                qmax_bytes=cfg.qmax_bytes, n_links=nl)
            p_sub, p_sub_fabric = dataplane.drill_mark_probs(
                topo, p_mark, w_spray, ca.sleaf, ca.dleaf, ca.dst)
            thr = thr * dataplane.drill_gbn_factor(
                topo, pq, w_spray, rc[..., 0], mtu_bytes=dp.mtu_bytes,
                jitter_mtus=cfg.drill_jitter_mtus, window_pkts=cfg.gbn_window_pkts,
                capacity=capv)
            thr = thr[..., None]
        else:
            if cached_fab:
                fab = ca.fab
            else:
                fab = topo.fabric_links(ca.sleaf, ca.dleaf, state.path[..., 0])[:, :, None, :]
            arrival, new_queue, p_mark, thr = dataplane.cascade_nic(
                fab, ca.tx, ca.rx, rc, state.queue, capv, qmask, n_links=nl,
                kmin=dp.kmin_bytes, kmax=dp.kmax_bytes, pmax=dp.pmax, dt=cfg.dt,
                qmax_bytes=cfg.qmax_bytes, backend=cfg.dataplane)
            p_sub, p_sub_fabric = dataplane.subflow_mark_probs_nic(
                fab, ca.tx, ca.rx, p_mark, nl)
            if loss is not None:
                thr = thr * dataplane.lossy_gbn_factor(
                    fab, ca.tx, ca.rx, loss, n_links=nl, window_pkts=cfg.gbn_window_pkts)
            if reorder is not None:
                # each delivered byte of a path-straddling chunk costs the
                # go-back-N rewinds; the offered load stays the DCQCN rate
                pq = dataplane.path_queue_2tier(topo, state.queue, ca.sleaf, ca.dleaf)
                thr = thr / dataplane.reorder_gbn_factor(
                    topo, pq, ca.spray, rc[..., 0], reorder, mtu_bytes=dp.mtu_bytes,
                    jitter_mtus=cfg.drill_jitter_mtus, window_pkts=cfg.gbn_window_pkts,
                    capacity=capv)[..., None]
        return arrival, new_queue, thr, p_sub, p_sub_fabric, rc, active

    def dcqcn_phase(state: CompactState, p_sub, active):
        """Per-sub-flow DCQCN rate update; returns the new DCQCNState."""
        return dcqcn_mod.step(state.cc, p_sub, active, cfg.dt, line_rate, dp)[0]

    def finish_phase(state: CompactState, t, thr, active, rc, p_sub_fabric):
        """Transfer progress, bitmap CQE, scatter-on-finish, Congestion
        Packet bookkeeping.  Returns (remaining, sub_done, cqe_bitmap,
        slot_fid, finish, table, exp_cong_pkts)."""
        occupied = state.slot_fid < F_pad
        delivered = thr * cfg.dt / 8.0
        new_remaining = torch.clamp(
            state.remaining - torch.where(active, delivered, 0.0), min=0.0)
        sub_done = occupied[..., None] & (new_remaining <= DONE_EPS_BYTES)
        cqe_bitmap = state.cqe_bitmap | shaper.subflow_bits(sub_done)
        all_done = ((cqe_bitmap & full_cqe) == full_cqe) & occupied
        # scatter-on-finish: empty slots carry the F_pad sentinel -> dropped
        done_t = torch.where(all_done, (t + cfg.dt)[:, None], torch.inf)
        finish = torch.cat([state.finish, state.finish[:, :1]], 1)
        finish = finish.scatter_reduce(1, state.slot_fid, done_t, reduce="amin",
                                       include_self=True)[:, :F_pad]

        table = state.table
        pkts = torch.where(active, rc * cfg.dt / (8.0 * dp.mtu_bytes), 0.0)
        marked = pkts * p_sub_fabric
        exp_cong_pkts = marked.sum((1, 2))
        if cfg.scheme == "seqbalance":
            nleaf = topo.n_leaf
            cell = (state.cache.sleaf.to(torch.int64)[..., None] * P
                    + torch.clamp(state.path, 0, P - 1).to(torch.int64))
            cell = cell + torch.arange(B, device=dev)[:, None, None] * (nleaf * P)
            intensity = dataplane.congestion_intensity(
                cell, marked, B * nleaf * P, max_pkts=line_rate * cfg.dt / (8.0 * dp.mtu_bytes))
            dense = intensity.view(B, nleaf, P) >= cfg.cong_threshold_pkts
            table = ctab.mark_congested_dense(table, dense, t[:, None, None], cfg.phi)
        slot_fid = torch.where(all_done, F_pad, state.slot_fid)
        return (new_remaining, sub_done, cqe_bitmap, slot_fid, finish, table,
                exp_cong_pkts)

    def step_fn(state: CompactState):
        # the record_function ranges name the phases in a torch.profiler
        # trace (chip_smoke.py's profile phase reads them)
        t = state.step.to(torch.float32) * cfg.dt
        with record_function("admit"):
            st = admit_phase(state)
        with record_function("cascade"):
            arrival, new_queue, thr, p_sub, p_sub_fabric, rc, active = cascade_phase(st)
        with record_function("dcqcn"):
            cc = dcqcn_phase(st, p_sub, active)
        with record_function("finish"):
            (remaining, sub_done, cqe_bitmap, slot_fid, finish, table,
             exp_cong_pkts) = finish_phase(st, t, thr, active, rc, p_sub_fabric)
        new_state = st._replace(
            slot_fid=slot_fid, remaining=remaining, sub_done=sub_done, cc=cc,
            cqe_bitmap=cqe_bitmap, finish=finish, table=table, queue=new_queue,
            cnp_pkts=st.cnp_pkts + exp_cong_pkts, step=st.step + 1,
        )
        out = StepOutputs(
            uplink_load=arrival[:, uplink_ids],
            goodput_total=torch.where(active, thr, 0.0).sum((1, 2)),
            cnp_rate=exp_cong_pkts,
            max_queue=new_queue[:, :nl].amax(1),
        )
        return new_state, out

    # ---- adaptive dt: the quiescence check and the closed-form macro-step
    n_valid = valid.sum(1)

    def arrival_check(state: CompactState, span: int) -> torch.Tensor:
        """bool[B]: no flow arrives inside the ``span`` steps from
        ``state.step``, so admission is a no-op there (a spill backlog
        means the next unadmitted arrival is already past, which fails)."""
        t_end = (state.step + span).to(torch.float32) * cfg.dt
        nxt = torch.gather(arrivals, 1, torch.clamp(state.admitted, 0, F_pad - 1)[:, None])[:, 0]
        return (state.admitted >= n_valid) | (nxt >= t_end)

    def steady_or_idle(state: CompactState, span: int):
        """(bool[B], frozen): each simulation idle (no slot occupied: stale
        slots offer exactly 0) or in a steady state that ``span`` steps
        cannot leave — every active sub-flow at rc == rt == line rate, no
        masked queue able to reach ff_kmin_frac * kmin under the constant
        offered load, no sub-flow able to finish within span +
        ff_margin_steps steps, and for the flowlet schemes no occupied slot
        at a flowlet gap.  DRILL's spray follows the queues, so it only
        counts idle spans and runs no cascade here, and so does a run with
        ``reorder``, whose cost follows the queues too.  ``frozen`` is the
        cascade's (arrival, thr, active) for the fast-forward to reuse."""
        occupied = state.slot_fid < F_pad
        idle = ~occupied.any(1)
        if cfg.scheme == "drill" or reorder is not None:
            return idle, None
        arrival, _, thr, _, _, rc, active = cascade_phase(state)
        delta = (arrival - cap_of(state)) * (cfg.dt / 8.0)
        q_hi = torch.maximum(state.queue, state.queue + delta * span) * qmask
        p_q = (q_hi[:, :nl] < cfg.ff_kmin_frac * dp.kmin_bytes).all(1)
        margin = span + max(cfg.ff_margin_steps, 1)
        need = rc * (margin * cfg.dt / 8.0) + DONE_EPS_BYTES
        p_fin = torch.where(active, state.remaining > need, True).flatten(1).all(1)
        pinned = (state.cc.rc == line_rate) & (state.cc.rt == line_rate)
        p_cc = torch.where(active, pinned, True).flatten(1).all(1)
        steady = p_q & p_fin & p_cc
        if flowlet:
            gap = baselines.flowlet_gap_occurs(state.cc.rc[..., 0], dp.mtu_bytes,
                                               cfg.flowlet_timeout)
            steady = steady & ~(gap & occupied).any(1)
        return idle | steady, (arrival, thr, active)

    def quiesce_phase(state: CompactState, span: int):
        """The reference's quiescence predicate for a ``span``-step
        macro-step from ``state.step``, per simulation: (cheap, quiet,
        frozen), ``cheap`` the arrival check, ``quiet`` it and the steady
        check.  The capacity-edge check depends on the shared step alone,
        so the caller makes it on the host before it calls this."""
        cheap = arrival_check(state, span)
        steady, frozen = steady_or_idle(state, span)
        return cheap, cheap & steady, frozen

    def fast_forward_phase(state: CompactState, span: int, counted, frozen=None):
        """Advance ``span`` steps in closed form, exact where
        ``quiesce_phase`` holds: queues follow the clipped linear
        trajectory, remaining bytes fall at the frozen delivered rate, DCQCN
        is timer bookkeeping (``dcqcn.fast_forward``); slots, bitmaps,
        finishes, the table and the counters stay.  ``ff_steps`` grows by
        ``span`` where ``counted`` (bool[B]).  ``frozen`` reuses the check's
        cascade (None: run it).  Returns (state, (uplink f32[B, L, S],
        goodput f32[B], max_queue f32[B, span])): the per-step outputs are
        constant over the span but max_queue, and the uplink load is the
        window average of a constant."""
        if frozen is None:
            arrival, _, thr, _, _, _, active = cascade_phase(state)
        else:
            arrival, thr, active = frozen
        q_final, mq_traj = dataplane.queue_fast_forward(
            state.queue, arrival, cap_of(state), qmask, dt=cfg.dt, n_steps=span,
            qmax_bytes=cfg.qmax_bytes, n_links=nl)
        delivered = thr * (span * cfg.dt / 8.0)
        remaining = torch.clamp(state.remaining - torch.where(active, delivered, 0.0),
                                min=0.0)
        cc = dcqcn_mod.fast_forward(state.cc, active, span, cfg.dt, dp)
        new_state = state._replace(
            remaining=remaining, cc=cc, queue=q_final, step=state.step + span,
            ff_steps=state.ff_steps + span * counted.to(torch.int64))
        goodput = torch.where(active, thr, 0.0).sum((1, 2))
        return new_state, (arrival[:, uplink_ids], goodput, mq_traj)

    return init_state, step_fn, dict(
        admit=admit_phase, cascade=cascade_phase, dcqcn=dcqcn_phase, finish=finish_phase,
        quiesce=quiesce_phase, fast_forward=fast_forward_phase)


class _ArrivalGate:
    """The arrival check made on the host from the sorted arrivals alone,
    before any device work: it can rule a span out, never in.  Admission
    at the last step before boundary k admitted at most the c flows that
    had arrived by then, so the next unadmitted arrival is at most the
    c-th; if that one falls inside the span, the device's check fails too
    (``checks_ruled_out`` counts the checks it let through that failed)."""

    def __init__(self, arrivals: torch.Tensor, n_valid: torch.Tensor, dt: float):
        self.arr = arrivals.cpu().numpy()
        self.n_valid = n_valid.cpu().numpy()
        self.dt = np.float32(dt)

    def may_pass(self, k: int, span: int) -> np.ndarray:
        t_last = np.nextafter(np.float32(k - 1) * self.dt, np.float32(np.inf))
        t_end = np.float32(k + span) * self.dt
        out = np.empty(self.arr.shape[0], bool)
        for b, (arr, nv) in enumerate(zip(self.arr, self.n_valid)):
            c = int(np.searchsorted(arr, t_last, side="right"))
            out[b] = c >= nv or arr[c] >= t_end
        return out


_COUNT_LOCK = threading.Lock()


def _count(**adds) -> None:
    with _COUNT_LOCK:
        for key, n in adds.items():
            run_core.counts[key] += n


def _select(mask: torch.Tensor, a, b):
    """Simulation b of the result is a's where mask[b], else b's, over
    every tensor of two states (nested NamedTuples included)."""
    if isinstance(a, tuple):
        return type(a)(*(_select(mask, x, y) for x, y in zip(a, b)))
    return torch.where(mask.reshape(-1, *([1] * (a.dim() - 1))), a, b)


class _Recorder:
    """The flight recorder's side of ``run_core``: the ring, and one row per
    block from the outputs the loop has already written (the chunk's
    per-step slab, or the fast-forward's constants), the block's uplink
    offered load, the state at its end and the uplink capacity of its first
    step."""

    def __init__(self, spec, topo: Topology, capacity, cap_seg_steps: int, B: int,
                 F_pad: int):
        from repro_torch.obs import recorder

        self.recorder, self.spec, self.F_pad = recorder, spec, F_pad
        dev = topo.device
        self.uplink_flat = torch.as_tensor(topo.uplink_ids.ravel().astype(np.int64), device=dev)
        self.ring = recorder.ring_init(spec, self.uplink_flat.numel(), B, device=dev)
        self.cap = topo.capacity if capacity is None else capacity
        self.seg = max(int(cap_seg_steps), 1)

    def cap_row(self, k: int) -> torch.Tensor:
        cap = self.cap
        if cap.dim() == 2:
            cap = cap[min(k // self.seg, cap.shape[0] - 1)]
        return cap[self.uplink_flat]

    def write(self, st, per_step, k0: int, length: int, ff, offered, write) -> None:
        """One row per simulation where ``write`` (bool[B]): the block of
        ``length`` steps from ``k0``; ``ff`` a number or bool[B];
        ``offered`` f32[B, U] the block's mean uplink load."""
        cols = slice(k0, k0 + length)
        mq = per_step[2][:, cols]
        active = (st.slot_fid < self.F_pad)[..., None] & ~st.sub_done
        self.ring = self.recorder.record_chunk(
            self.spec, self.ring, step0=k0, steps=length, ff=ff,
            queue_max=mq.amax(1), queue_mean=mq.mean(1), cnp=per_step[1][:, cols].sum(1),
            goodput=per_step[0][:, cols].mean(1), offered=offered,
            cap=self.cap_row(k0), rc=st.cc.rc, active=active, write=write)


def run_core(topo: Topology, cfg: SimConfig, W: int, F_pad: int, A: int, n_steps: int,
             trace_arrays: tuple, *, capacity=None, loss=None, cap_seg_steps: int = 0,
             reorder=None, record=None):
    """Run B simulations to the horizon (or to the early exit), with the
    traced ``capacity``, ``loss`` and ``reorder`` operands of
    ``build_compact_sim``.

    Returns (final_state, outs, steps): ``outs`` is a StepOutputs of
    [B, n_steps] tensors (uplink_load [B, n_steps // s, L, S], window
    averaged over ``s = cfg.uplink_sample_every`` steps) and ``steps`` the
    dt steps run.  Once every flow has been admitted and finished and the
    queues have drained, the remaining steps are exact no-ops, so the loop
    stops at the next chunk boundary.

    With ``cfg.adaptive`` each chunk boundary checks, per simulation, that
    the next macro-step (``ff_macro_chunks`` chunks) is quiet
    (``quiesce_phase``) and fast-forwards quiet simulations in closed form,
    as the reference's per-simulation ``lax.cond`` does.  The checks that
    need no device work come first: the horizon, the capacity-schedule
    edge, and an arrival check on the host (``_ArrivalGate``); only past
    them is the steady-state check's cascade launched.  The check's flags
    come back in the chunk boundary's one host sync, with the early-exit
    test.  If none is quiet the batch steps K steps; if every live one is,
    the batch fast-forwards; otherwise it steps K steps and the quiet
    simulations take the fast-forward's state and outputs.  So each
    simulation ends as it would alone, in lockstep with the others.  With
    B > 1, ``ff_macro_chunks > 1`` would let the simulations drift apart
    and raises NotImplementedError (``sweep.run_batch`` runs such a
    batch one simulation at a time).

    ``record`` (an ``obs.recorder.RecordSpec``) carries the flight
    recorder's ring beside the state and returns it as a fourth output:
    each simulation that is still running at a block's start writes one row
    for the block (a fast-forwarded macro-step with ``ff`` = 1), the row it
    would write alone.  Recording reads the loop's outputs and changes no
    result; ``record=None`` adds no operation to the step loop.

    ``run_core.counts`` adds up, over calls, the steps stepped
    (``scanned_steps``), the steady-state checks that launched a cascade
    (``steady_checks``; DRILL's and a ``reorder`` run's launch none), those
    of them at a boundary where some simulation was live and none of the
    live ones passed the arrival check (``checks_ruled_out``), and the macro-steps fast-forwarded
    (``fast_forwards``, of which ``mixed_fast_forwards`` were taken by part
    of the batch)."""
    init_state, step_fn, phases = build_compact_sim(
        topo, cfg, trace_arrays, W, F_pad, A, capacity, loss, cap_seg_steps, reorder)
    st = init_state()
    dev = topo.device
    B = trace_arrays[0].shape[0]
    nl = topo.n_links
    n_valid = trace_arrays[5].sum(1)
    s = cfg.uplink_sample_every
    K, n_chunks, tail = plan_chunks(cfg, n_steps)
    horizon = n_chunks * K
    n_samples = n_steps // s
    up_shape = topo.uplink_ids.shape
    uplink = torch.zeros((B, n_samples, *up_shape), dtype=torch.float32, device=dev)
    per_step = [torch.zeros((B, n_steps), dtype=torch.float32, device=dev) for _ in range(3)]
    up_acc = torch.zeros((B, *up_shape), dtype=torch.float32, device=dev)
    rec = None if record is None else _Recorder(record, topo, capacity, cap_seg_steps, B, F_pad)

    def alive_mask(st) -> torch.Tensor:
        return ((st.admitted < n_valid)
                | (st.slot_fid < F_pad).any(1)
                | (st.queue[:, :nl].amax(1) > 0.0))

    k = 0

    def run_block(st, length):
        """Step ``length`` steps: (state, the block's mean uplink load
        f32[B, U] for the recorder, None without it)."""
        nonlocal k, up_acc
        block_up = None
        for _ in range(length):
            st, o = step_fn(st)
            per_step[0][:, k] = o.goodput_total
            per_step[1][:, k] = o.cnp_rate
            per_step[2][:, k] = o.max_queue
            up_acc = up_acc + o.uplink_load
            if rec is not None:
                block_up = o.uplink_load if block_up is None else block_up + o.uplink_load
            if (k + 1) % s == 0:
                if k // s < n_samples:
                    uplink[:, k // s] = up_acc / s
                up_acc = torch.zeros_like(up_acc)
            k += 1
        _count(scanned_steps=length)
        return st, None if rec is None else (block_up / length).reshape(B, -1)

    def stepped(st0, length, write):
        """A stepped block, recorded where ``write``."""
        k0 = k
        st, offered = run_block(st0, length)
        if rec is not None:
            rec.write(st, per_step, k0, length, 0, offered, write)
        return st

    def write_ff(k0, rows, span, up, goodput, mq):
        """The fast-forward's outputs for steps [k0, k0 + span) of ``rows``
        (bool[B] tensor, or None for every simulation)."""
        cols, wins = slice(k0, k0 + span), slice(k0 // s, (k0 + span) // s)
        new = (goodput[:, None].expand(B, span), torch.zeros_like(mq), mq)
        for out, v in zip(per_step, new):
            out[:, cols] = v if rows is None else torch.where(rows[:, None], v, out[:, cols])
        v = up[:, None].expand_as(uplink[:, wins])
        uplink[:, wins] = v if rows is None else torch.where(
            rows.reshape(B, 1, *([1] * len(up_shape))), v, uplink[:, wins])

    def ff_offered(k0, span):
        """The fast-forward's mean uplink load over its windows, f32[B, U]."""
        return uplink[:, k0 // s:(k0 + span) // s].mean(1).reshape(B, -1)

    if cfg.adaptive:
        macro = K * cfg.ff_macro_chunks
        if B > 1 and cfg.ff_macro_chunks > 1:
            raise NotImplementedError("ff_macro_chunks > 1 lets the simulations of a batch "
                                      "drift apart: run them one at a time")
        quiesce, fast_forward = phases["quiesce"], phases["fast_forward"]
        gate = _ArrivalGate(trace_arrays[1], n_valid, cfg.dt)
        seg = max(int(cap_seg_steps), 1)
        n_rows = capacity.shape[0] if capacity is not None and capacity.dim() == 2 else 0
        live = np.ones(B, bool)  # a simulation that has ended stays ended
        none = np.zeros(B, bool)
        while k < horizon:
            edge_free = n_rows == 0 or (min(k // seg, n_rows - 1)
                                        == min((k + macro - 1) // seg, n_rows - 1))
            maybe = (live & gate.may_pass(k, macro)
                     if edge_free and k + macro <= horizon else none)
            quiet, frozen = none, None
            if maybe.any():
                cheap, quiet_t, frozen = quiesce(st, macro)
                flags = torch.stack([alive_mask(st), cheap, quiet_t])
                live, cheap, quiet = flags.cpu().numpy()
                live_t = flags[0]
                cheap, quiet = cheap & live, quiet & live
                if frozen is not None:  # a check at the exit boundary is not ruled out
                    _count(steady_checks=1,
                           checks_ruled_out=int(live.any() and not cheap.any()))
            else:
                live_t = alive_mask(st)
                live = live_t.cpu().numpy()
            if not live.any():
                break
            if not quiet.any():
                st = stepped(st, K, live_t)
                continue
            rows = torch.as_tensor(quiet, device=dev)
            st_ff, (up, goodput, mq) = fast_forward(st, macro, rows, frozen)
            k0 = k
            if (quiet | ~live).all():
                write_ff(k0, None, macro, up, goodput, mq)
                st = st_ff
                k += macro
                if rec is not None:
                    rec.write(st, per_step, k0, macro, 1, ff_offered(k0, macro), live_t)
                _count(fast_forwards=1)
            else:
                st_run, offered = run_block(st, K)
                st = _select(rows, st_ff, st_run)
                write_ff(k0, rows, K, up, goodput, mq)
                if rec is not None:
                    rec.write(st, per_step, k0, K, rows,
                              torch.where(rows[:, None], ff_offered(k0, K), offered), live_t)
                _count(fast_forwards=1, mixed_fast_forwards=1)
    else:
        while k < horizon:
            live_t = alive_mask(st)
            if not bool(live_t.any()):
                break
            st = stepped(st, K, live_t)
    if tail:
        live_t = alive_mask(st)
        if bool(live_t.any()):
            st = stepped(st, tail, live_t)
    outs = StepOutputs(uplink, per_step[0], per_step[1], per_step[2])
    if rec is None:
        return st, outs, k
    return st, outs, k, rec.ring


run_core.counts = dict(scanned_steps=0, steady_checks=0, checks_ruled_out=0,
                       fast_forwards=0, mixed_fast_forwards=0)


def simulate_compact(topo: Topology, cfg: SimConfig, trace: Trace, *,
                     window_slots: int | None = None, reorder=None, device=None):
    """One-shot compact run of a single trace (for sweeps use
    netsim/sweep.py).  ``reorder`` (packets or None) turns on the flowcell
    reordering cost.  Returns (CompactResult, StepOutputs of numpy arrays
    without the batch dimension)."""
    device = resolve_device(device)
    topo = topo.to(device)
    arrays, inv, F = sort_trace(trace)
    F_pad = max(F, 1)
    W, A = plan_single_window(topo, cfg, arrays, F_pad)
    if window_slots is not None:  # explicit window: honor it exactly
        W = max(8, min(int(window_slots), F_pad))
    n_steps = int(round(cfg.duration_s / cfg.dt))
    stacked = tuple(a[None] for a in pad_trace_arrays(arrays, F_pad))
    if reorder is not None:
        reorder = torch.tensor(reorder, dtype=torch.float32, device=device)
    st, outs, steps = run_core(topo, cfg, W, F_pad, A, n_steps,
                               trace_tensors(stacked, device), reorder=reorder)
    res = CompactResult(
        finish=st.finish[0].cpu().numpy()[:F][inv],
        cnp_pkts=st.cnp_pkts[0].cpu().numpy(),
        spill_steps=int(st.spill_steps[0]),
        window_slots=W,
        steps=steps,
        ff_steps=int(st.ff_steps[0]),
    )
    return res, StepOutputs(*(o[0].cpu().numpy() for o in outs))
