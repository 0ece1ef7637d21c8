"""Fluid flow-level datacenter simulator, the dense O(F) oracle, mirroring
``repro.netsim.engine``: the scheme list, the configuration, the per-step
outputs, the per-flow constants derived once from a trace (shared with the
active-window engine ``compact``), and ``simulate``.

``simulate`` steps every flow of the trace every ``dt``: the reference's
fixed-length ``lax.scan`` becomes a Python loop of ``n_steps`` steps with
no host synchronisation inside it, and the per-step outputs are stacked
to ``[T, ...]``.  The dataplane is ``dataplane.cascade_nic``, which on the
card launches the CUDA kernel ``csrc/cascade_tiered.cu`` (DRILL runs its
spray in plain PyTorch).  The state has the reference's shapes, without
the compact engine's batch dimension.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

import numpy as np

from repro_torch import resolve_device
from repro_torch.core import baselines, congestion_table as ctab, hashing, routing, shaper
from repro_torch.netsim import dataplane, dcqcn as dcqcn_mod
from repro_torch.netsim.topology import Topology
from repro_torch.netsim.workloads import Trace

SCHEMES = ("seqbalance", "ecmp", "letflow", "conga", "drill", "flowlet_timeout")

# A sub-flow is complete when its remaining bytes drop below this (see the
# reference: an exact-zero test would tail on f32 underflow).
DONE_EPS_BYTES = 0.125


@dataclasses.dataclass(frozen=True)
class SimConfig:
    scheme: str = "seqbalance"
    n_sub: int = 4  # N (SeqBalance Shaper); forced to 1 for other schemes
    min_split_bytes: float = 16e3  # Shaper floor: WQEs below this stay whole
    phi: float = 32e-6
    flowlet_timeout: float = 100e-6
    dt: float = 10e-6
    duration_s: float = 20e-3
    dcqcn: dcqcn_mod.DCQCNParams = dcqcn_mod.DCQCNParams()
    gbn_window_pkts: float = 16.0
    drill_jitter_mtus: float = 4.0
    drill_q0: float = 1500.0
    qmax_bytes: float = 8e6
    # a path is declared congested when at least this many ECN-marked
    # packets are mirrored back to the source ToR within one step
    cong_threshold_pkts: float = 1.0
    # "auto" (the CUDA kernel on CUDA tensors, plain PyTorch on the CPU);
    # "cuda" and "torch" assert one of the two — see netsim/dataplane.py
    dataplane: str = "auto"
    # the step loop runs in chunks of this many steps; the early exit is
    # checked once per chunk
    chunk_steps: int = 32
    # window-average the [T, L, S] uplink trace over this many steps
    uplink_sample_every: int = 1
    # compact engine only: event-driven adaptive dt.  Each chunk boundary
    # evaluates a quiescence check (no arrival, capacity-segment edge,
    # finish or ECN crossing possible inside the macro-step, DCQCN pinned
    # at line rate) and, where it holds, advances the macro-step in closed
    # form instead of stepping it (compact.run_core).  The dense engine
    # ignores it, as the reference's does.
    adaptive: bool = False
    # the macro-step, in chunks of chunk_steps steps
    ff_macro_chunks: int = 1
    # margins of the check: queues stay below ff_kmin_frac * kmin over the
    # span, and no active sub-flow can finish within span + ff_margin_steps
    ff_kmin_frac: float = 0.9
    ff_margin_steps: int = 2

    def __post_init__(self):
        if self.scheme not in SCHEMES:
            raise ValueError(f"unknown scheme {self.scheme!r}")
        if self.dataplane not in dataplane.BACKENDS:
            raise ValueError(f"dataplane {self.dataplane!r} not in {dataplane.BACKENDS}")
        if self.chunk_steps < 1 or self.uplink_sample_every < 1:
            raise ValueError("chunk_steps and uplink_sample_every must be >= 1")
        if self.ff_macro_chunks < 1 or self.ff_margin_steps < 0:
            raise ValueError("ff_macro_chunks must be >= 1 and ff_margin_steps >= 0")
        if not 0.0 < self.ff_kmin_frac <= 1.0:
            raise ValueError(f"ff_kmin_frac {self.ff_kmin_frac} not in (0, 1]")
        if self.scheme != "seqbalance":
            object.__setattr__(self, "n_sub", 1)


class SimState(NamedTuple):
    remaining: torch.Tensor  # f32[F, N] bytes
    path: torch.Tensor  # i32[F, N]
    assigned: torch.Tensor  # bool[F]
    sub_done: torch.Tensor  # bool[F, N]
    finish: torch.Tensor  # f32[F] (+inf until CQE)
    cc: dcqcn_mod.DCQCNState  # [F, N]
    table: ctab.CongestionTable  # [n_leaf, n_paths]
    queue: torch.Tensor  # f32[n_links + 1]
    cqe: shaper.CQEState  # [F]
    cnp_pkts: torch.Tensor  # f32 scalar: Congestion Packet counter (Table II)
    step: torch.Tensor  # i64 scalar


class StepOutputs(NamedTuple):
    uplink_load: torch.Tensor  # f32[..., n_leaf, n_uplinks] offered bps
    goodput_total: torch.Tensor  # f32 bps (sum of delivered)
    cnp_rate: torch.Tensor  # f32 congestion packets this step
    max_queue: torch.Tensor  # f32 bytes


class FlowConsts(NamedTuple):
    """Per-flow constants derived once from the trace, each with the
    trace's leading dimensions ([B, F] below)."""

    sub_sizes: torch.Tensor  # f32[B, F, N] Shaper split (min_split floor applied)
    s5: tuple  # 4 x u32[B, F, N] per-sub-flow five-tuples (SeqBalance QPs)
    f5: tuple  # 4 x u32[B, F] per-flow five-tuple (other schemes)
    sub_salt: torch.Tensor  # u32[B, F, N] DCQCN mark-draw salt
    src_leaf: torch.Tensor  # i32[B, F]
    dst_leaf: torch.Tensor  # i32[B, F]


def flow_constants(topo: Topology, cfg: SimConfig, sizes, src, dst, fid) -> FlowConsts:
    """uint32 quantities are int64 tensors (see ``core``)."""
    N = cfg.n_sub
    sub_sizes = shaper.split_wqe(sizes, N)
    if N > 1:
        # WQEs below the Shaper floor ride a single QP (sub-WQE 0); their
        # sibling slots carry zero bytes and are born completed
        whole = torch.cat([sizes[..., None], torch.zeros_like(sub_sizes[..., 1:])], -1)
        split_mask = (sizes >= cfg.min_split_bytes)[..., None]
        sub_sizes = torch.where(split_mask, sub_sizes, whole)
    fid = hashing.u32(fid)
    s5 = shaper.subflow_five_tuples(src, dst, fid, N)
    f5 = (hashing.u32(src), hashing.u32(dst), 0xB000 + hashing.fmix32(fid) % 0x3FFF,
          torch.full_like(fid, 4791))
    sub_salt = hashing.fmix32(s5[2] ^ hashing.mul32(fid, 2246822519)[..., None])
    hpl = topo.hosts_per_leaf
    src_leaf = (torch.as_tensor(src) // hpl).to(torch.int32)
    dst_leaf = (torch.as_tensor(dst) // hpl).to(torch.int32)
    return FlowConsts(sub_sizes.contiguous(), s5, f5, sub_salt, src_leaf, dst_leaf)


def line_rate_of(topo: Topology) -> float:
    """The host_tx[0] bandwidth (a float32 value)."""
    return float(topo.capacity[topo.n_links - 2 * topo.n_hosts])


def check_reorder(topo: Topology, cfg: SimConfig) -> None:
    """The flowcell reordering cost is modelled on 2-tier fabrics, and not
    for DRILL, whose spray pays its own go-back-N factor."""
    if topo.kind != "leaf_spine":
        raise ValueError("the reorder cost model is 2-tier only")
    if cfg.scheme == "drill":
        raise ValueError("DRILL carries its own go-back-N factor (drill_gbn_factor)")


def build_sim(topo: Topology, cfg: SimConfig, trace: Trace, reorder=None):
    """Returns (init_state, step_fn) for the scheme, topology and trace, on
    the topology's device; ``step_fn(state) -> (state, StepOutputs)``.

    ``reorder`` (packets, a float or None) turns on the flowcell reordering
    cost: delivered throughput divides by ``dataplane.reorder_gbn_factor``
    wherever the trace's ``spray`` column says a flow's chunk straddles more
    than one path.  ``None`` runs the program without it."""
    if cfg.scheme in ("conga", "drill", "flowlet_timeout") and topo.kind != "leaf_spine":
        raise ValueError(f"{cfg.scheme} is 2-tier only (paper §IV.B)")
    if reorder is not None:
        check_reorder(topo, cfg)
    dev = topo.device
    F = len(trace.sizes)
    N = cfg.n_sub
    P = topo.n_paths
    nl = topo.n_links
    sizes = torch.as_tensor(np.asarray(trace.sizes), dtype=torch.float32, device=dev)
    arrivals = torch.as_tensor(np.asarray(trace.arrivals), dtype=torch.float32, device=dev)
    src = torch.as_tensor(np.asarray(trace.src), dtype=torch.int32, device=dev)
    dst = torch.as_tensor(np.asarray(trace.dst), dtype=torch.int32, device=dev)
    fid = torch.as_tensor(np.asarray(trace.flow_id).astype(np.int64), device=dev)
    valid = torch.as_tensor(np.asarray(trace.valid), dtype=torch.bool, device=dev)
    spray = torch.as_tensor(np.asarray(trace.spray), dtype=torch.int32, device=dev)
    if reorder is not None:
        reorder = torch.tensor(reorder, dtype=torch.float32, device=dev)

    fc = flow_constants(topo, cfg, sizes, src, dst, fid)
    src_leaf, dst_leaf = fc.src_leaf, fc.dst_leaf
    line_rate = line_rate_of(topo)
    cap = topo.capacity
    qmask = dataplane.queue_mask_for(topo)
    dp = cfg.dcqcn
    tx_link, rx_link = topo.nic_links(src, dst)  # i32[F], path-independent
    uplink_ids = torch.as_tensor(topo.uplink_ids.astype(np.int64), device=dev)
    cell_leaf = src_leaf.to(torch.int64)[:, None].expand(F, N) * P  # intensity rows
    if cfg.scheme == "flowlet_timeout":
        # WCMP re-draw weights from the static uplink capacities: fat
        # uplinks take proportionally more flowlets
        up_w = baselines.wcmp_weights(cap[: topo.n_leaf * P].reshape(topo.n_leaf, P))
        up_w = up_w[src_leaf.to(torch.int64)]  # [F, P]

    def init_state() -> SimState:
        return SimState(
            remaining=fc.sub_sizes.clone(),
            path=torch.full((F, N), -1, dtype=torch.int32, device=dev),
            assigned=torch.zeros((F,), dtype=torch.bool, device=dev),
            sub_done=fc.sub_sizes <= 0.0,
            finish=torch.full((F,), torch.inf, dtype=torch.float32, device=dev),
            cc=dcqcn_mod.init_state((F, N), line_rate, dev),
            table=ctab.CongestionTable.create(topo.n_leaf, P, dev),
            queue=torch.zeros((nl + 1,), dtype=torch.float32, device=dev),
            cqe=shaper.CQEState.create(F, N, dev),
            cnp_pkts=torch.zeros((), dtype=torch.float32, device=dev),
            step=torch.zeros((), dtype=torch.int64, device=dev),
        )

    def place(state: SimState, t, newly, active_flow) -> torch.Tensor:
        """Path (re)assignment: [F, N] paths after this step's choices."""
        path = state.path
        if cfg.scheme == "seqbalance":
            inact = ctab.inactive_matrix(state.table, t)  # [L, P]
            # a table marking more than half of a ToR's paths carries no
            # routing signal: fall back to the plain hash (the reference's
            # stale-table rule)
            stale = inact.sum(-1, keepdim=True) > (P // 2)
            inact = inact & ~stale
            rows = inact[src_leaf.to(torch.int64)][:, None, :].expand(F, N, P)
            p_new = routing.select_paths(*fc.s5, rows, P)
            return torch.where(newly[:, None], p_new, path)
        if cfg.scheme == "ecmp":
            p_new = routing.ecmp_paths(*fc.f5, P)[:, None]
            return torch.where(newly[:, None], p_new, path)
        if cfg.scheme in ("letflow", "conga", "flowlet_timeout"):
            rng = hashing.fmix32(fid ^ hashing.mul32(state.step, 0x85EBCA77))
            p_init = routing.ecmp_paths(*fc.f5, P)
            gap = baselines.flowlet_gap_occurs(state.cc.rc[:, 0], dp.mtu_bytes,
                                               cfg.flowlet_timeout)
            if cfg.scheme == "letflow":
                p_re = baselines.letflow_paths(path[:, 0], gap, rng, P)
            elif cfg.scheme == "flowlet_timeout":
                p_re = baselines.flowlet_wcmp_paths(path[:, 0], gap, rng, up_w)
            else:
                pq = dataplane.path_queue_2tier(topo, state.queue[None], src_leaf[None],
                                                dst_leaf[None])[0]
                p_re = baselines.conga_paths(path[:, 0], gap, pq)
            p_next = torch.where(newly, p_init, torch.where(active_flow, p_re, path[:, 0]))
            return p_next[:, None]
        # drill: nominal path 0; the real split is the spray weights
        return torch.where(newly[:, None], torch.zeros_like(path), path)

    def dataplane_step(state: SimState, rc, active, path):
        """Offered rates -> hop cascade -> queue/ECN marks.  Returns
        (arrival, new_queue, thr, p_sub, p_sub_fabric), without the batch
        dimension the dataplane functions take."""
        if cfg.scheme == "drill":
            arrival, thr, w, pq = dataplane.drill_spray(
                topo, state.queue[None], rc[None, :, 0], src[None], dst[None],
                src_leaf[None], dst_leaf[None], active[None, :, 0:1], cfg.drill_q0)
            new_queue, p_mark = dataplane.integrate_queue(
                state.queue[None], arrival, cap, qmask, dp, dt=cfg.dt,
                qmax_bytes=cfg.qmax_bytes, n_links=nl)
            p_sub, p_sub_fabric = dataplane.drill_mark_probs(
                topo, p_mark, w, src_leaf[None], dst_leaf[None], dst[None])
            thr = thr * dataplane.drill_gbn_factor(
                topo, pq, w, rc[None, :, 0], mtu_bytes=dp.mtu_bytes,
                jitter_mtus=cfg.drill_jitter_mtus, window_pkts=cfg.gbn_window_pkts)
            thr = thr[..., None]
        else:
            fab = topo.fabric_links(src_leaf[:, None], dst_leaf[:, None], path)[None]
            arrival, new_queue, p_mark, thr = dataplane.cascade_nic(
                fab, tx_link[None], rx_link[None], rc[None], state.queue[None], cap,
                qmask, n_links=nl, kmin=dp.kmin_bytes, kmax=dp.kmax_bytes, pmax=dp.pmax,
                dt=cfg.dt, qmax_bytes=cfg.qmax_bytes, backend=cfg.dataplane)
            p_sub, p_sub_fabric = dataplane.subflow_mark_probs_nic(
                fab, tx_link[None], rx_link[None], p_mark, nl)
            if reorder is not None:
                pq = dataplane.path_queue_2tier(topo, state.queue[None], src_leaf[None],
                                                dst_leaf[None])
                thr = thr / dataplane.reorder_gbn_factor(
                    topo, pq, spray[None], rc[None, :, 0], reorder, mtu_bytes=dp.mtu_bytes,
                    jitter_mtus=cfg.drill_jitter_mtus,
                    window_pkts=cfg.gbn_window_pkts)[..., None]
        return arrival[0], new_queue[0], thr[0], p_sub[0], p_sub_fabric[0]

    def step_fn(state: SimState):
        t = state.step.to(torch.float32) * cfg.dt
        arrived = valid & (t >= arrivals)
        newly = arrived & ~state.assigned
        active_flow = state.assigned & torch.isinf(state.finish)
        path = place(state, t, newly, active_flow)
        assigned = state.assigned | newly

        active = (assigned[:, None] & ~state.sub_done
                  & torch.isinf(state.finish)[:, None])
        # a sub-flow never offers more than the bytes it still has to send
        rc = torch.where(active, torch.minimum(state.cc.rc, state.remaining * 8.0 / cfg.dt),
                         0.0)
        arrival, new_queue, thr, p_sub, p_sub_fabric = dataplane_step(state, rc, active,
                                                                      path)

        # transfer progress and CQE
        delivered = thr * cfg.dt / 8.0
        new_remaining = torch.clamp(
            state.remaining - torch.where(active, delivered, 0.0), min=0.0)
        sub_done = assigned[:, None] & (new_remaining <= DONE_EPS_BYTES)
        cqe = shaper.ack_mask(state.cqe, sub_done)
        all_done = shaper.cqe_ready(cqe) & assigned & valid
        finish = torch.where(torch.isinf(state.finish) & all_done, t + cfg.dt, state.finish)

        cc, _ = dcqcn_mod.step(state.cc, p_sub, active, cfg.dt, line_rate, dp)

        # SeqBalance Congestion Packets: the expected marked data packets per
        # (source ToR, path) this step; one or more closes the path for phi
        table = state.table
        pkts = torch.where(active, rc * cfg.dt / (8.0 * dp.mtu_bytes), 0.0)
        marked = pkts * p_sub_fabric
        exp_cong_pkts = marked.sum()
        if cfg.scheme == "seqbalance":
            cell = cell_leaf + torch.clamp(path, 0, P - 1).to(torch.int64)
            intensity = dataplane.congestion_intensity(
                cell, marked, topo.n_leaf * P, max_pkts=line_rate * cfg.dt / (8.0 * dp.mtu_bytes))
            dense = intensity.view(topo.n_leaf, P) >= cfg.cong_threshold_pkts
            table = ctab.mark_congested_dense(table, dense, t, cfg.phi)

        new_state = SimState(
            remaining=new_remaining, path=path, assigned=assigned, sub_done=sub_done,
            finish=finish, cc=cc, table=table, queue=new_queue, cqe=cqe,
            cnp_pkts=state.cnp_pkts + exp_cong_pkts, step=state.step + 1,
        )
        out = StepOutputs(
            uplink_load=arrival[uplink_ids],
            goodput_total=torch.where(active, thr, 0.0).sum(),
            cnp_rate=exp_cong_pkts,
            max_queue=new_queue[:nl].amax(),
        )
        return new_state, out

    return init_state, step_fn


def simulate(topo: Topology, cfg: SimConfig, trace: Trace, reorder=None,
             device=None) -> tuple[SimState, StepOutputs]:
    """Run the dense fluid simulation for ``cfg.duration_s``; returns
    (final_state, per-step outputs stacked to [T, ...]), tensors on
    ``device`` (``None`` means ``"cuda"``).  ``reorder`` (packets or None):
    the flowcell reordering cost of ``build_sim``."""
    topo = topo.to(resolve_device(device))
    init_state, step_fn = build_sim(topo, cfg, trace, reorder)
    n_steps = int(round(cfg.duration_s / cfg.dt))
    dev = topo.device
    state = init_state()
    outs = StepOutputs(
        uplink_load=torch.zeros((n_steps, *topo.uplink_ids.shape), dtype=torch.float32,
                                device=dev),
        goodput_total=torch.zeros((n_steps,), dtype=torch.float32, device=dev),
        cnp_rate=torch.zeros((n_steps,), dtype=torch.float32, device=dev),
        max_queue=torch.zeros((n_steps,), dtype=torch.float32, device=dev),
    )
    for k in range(n_steps):
        state, o = step_fn(state)
        for acc, v in zip(outs, o):
            acc[k] = v
    return state, outs
