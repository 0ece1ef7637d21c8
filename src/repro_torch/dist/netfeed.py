"""Simulator -> planner feedback, mirroring ``repro.dist.netfeed``: close
the loop between the fluid fabric simulator and the path planner.

One cycle:

  1. a ``PathPlan`` becomes the ring schedule it would put on the wire
     (``netsim.workloads.collective_trace``);
  2. the fluid simulator runs it over a (possibly degraded) topology;
  3. ``report_congestion`` turns the run's per-uplink offered load against
     capacity into ``LinkHealth.report_slow`` events, as a deployment
     would from CNP counters or late chunks;
  4. ``LinkHealth.plan`` makes the next plan, which routes around the
     congested or failed paths.

Path identity: on ``leaf_spine`` a ToR uplink is a path (path p crosses
spine p); on ``three_tier`` uplink a carries the ``n_core`` paths (a, c),
so an overloaded uplink quarantines all of them.

Everything here reads numpy: the per-step outputs a sweep returns
(``outs.uplink_load`` f32[T', L, S], already on the host, read once an
epoch) and the capacity, which a topology keeps as a tensor on its device
and which is read back here once per call.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.dist.elastic import LinkHealth


def capacity_vector(topo, capacity=None) -> np.ndarray:
    """The capacity vector as numpy: ``capacity`` if given (an array or a
    tensor), else the topology's."""
    cap = topo.capacity if capacity is None else capacity
    if hasattr(cap, "detach"):
        cap = cap.detach().cpu().numpy()
    return np.asarray(cap)


def path_utilization(topo, outs, *, leaf: int | None = None,
                     capacity=None) -> np.ndarray:
    """Time-mean offered load / capacity per ToR uplink: [S] for one leaf,
    or the worst over the leaves.  ``capacity`` overrides the topology's
    (a co-sim epoch's fault state).

    A dead uplink (capacity 0, a killed spine) reads +inf, not 0: the
    offered load on it decays to zero once DCQCN chokes its flows, and
    dividing by a floor of 1 would make the one unusable path look like
    the idlest.  Deadness is decided on the capacity, before the ratio."""
    up = np.asarray(outs.uplink_load)  # [T', L, S]
    cap = capacity_vector(topo, capacity)[np.asarray(topo.uplink_ids)]  # [L, S]
    util = np.where(cap <= 0.0, np.inf, up.mean(axis=0) / np.maximum(cap, 1.0))
    return util[leaf] if leaf is not None else util.max(axis=0)


def hot_uplinks(topo, outs, *, capacity=None, top_n: int = 5) -> list[dict]:
    """The ``top_n`` busiest (leaf, spine) uplinks by time-mean utilization,
    hottest first, as JSON-able dicts ``{"leaf", "uplink", "link", "util",
    "offered_gbps"}`` for the flight log; a dead uplink's ``util`` is 1e6
    (not inf, so that the record stays strict JSON)."""
    up = np.asarray(outs.uplink_load)  # [T', L, S]
    ids = np.asarray(topo.uplink_ids)  # [L, S]
    cap = capacity_vector(topo, capacity)[ids]
    offered = up.mean(axis=0)  # [L, S]
    util = np.where(cap <= 0.0, 1e6, offered / np.maximum(cap, 1.0))
    out = []
    for k in np.argsort(util.ravel())[::-1][:top_n]:
        leaf, s = divmod(int(k), util.shape[1])
        out.append(dict(leaf=leaf, uplink=s, link=int(ids[leaf, s]),
                        util=round(float(util[leaf, s]), 6),
                        offered_gbps=round(float(offered[leaf, s]) / 1e9, 6)))
    return out


def _paths_for_uplink(topo, uplink: int) -> tuple[int, ...]:
    if topo.kind == "three_tier":
        n_core = topo.n_paths // topo.uplink_ids.shape[1]
        return tuple(uplink * n_core + c for c in range(n_core))
    return (uplink,)  # leaf_spine: uplink s is path s


def observe_congestion(topo, outs, *, leaf: int | None = None, overload: float = 1.5,
                       dead_capacity_frac: float = 0.01, capacity=None, loss=None,
                       loss_threshold: float = 1e-3) -> tuple[int, ...]:
    """The paths one run's per-uplink stats say are slow, in report order
    without repeats; no health changes (what the observer at the fabric
    sees, before the reports cross a telemetry channel).

    A path is slow when its uplink's time-mean offered load exceeded
    ``overload`` x capacity; when the uplink's capacity is below
    ``dead_capacity_frac`` of the leaves' median (a failed spine, whose
    offered load may have decayed to 0); or, given a ``loss`` vector, when
    a link on the path drops more than ``loss_threshold`` of its packets
    (go-back-N ruins its goodput before its utilization shows it)."""
    from repro_torch.netsim.topology import paths_for_link

    util = path_utilization(topo, outs, leaf=leaf, capacity=capacity)
    cap = capacity_vector(topo, capacity)[np.asarray(topo.uplink_ids)]  # [L, S]
    cap = cap[leaf] if leaf is not None else cap.min(axis=0)
    dead = cap < dead_capacity_frac * np.median(cap)
    slow: list[int] = []
    for u in range(util.shape[0]):
        if util[u] > overload or dead[u]:
            slow.extend(_paths_for_uplink(topo, u))
    if loss is not None:
        lv = np.asarray(loss)
        for link in np.nonzero(lv[:topo.n_links] > loss_threshold)[0]:
            slow.extend(paths_for_link(topo, int(link)))
    return tuple(dict.fromkeys(slow))


def report_congestion(health: LinkHealth, topo, outs, *, step: int = 0,
                      leaf: int | None = None, overload: float = 1.5,
                      dead_capacity_frac: float = 0.01, capacity=None, loss=None,
                      loss_threshold: float = 1e-3) -> tuple[int, ...]:
    """The perfect-channel feedback: every slow path ``observe_congestion``
    sees goes to ``health.report_slow`` at ``step``, in order.  (The
    co-sim's degraded-telemetry path sends the same observation through a
    ``faults.TelemetryChannel`` and admits what arrives with
    ``health.admit_report``.)  Returns the reported paths."""
    if health.n_paths != topo.n_paths:
        raise ValueError(f"health has {health.n_paths} paths, the topology {topo.n_paths}")
    slow = observe_congestion(topo, outs, leaf=leaf, overload=overload,
                              dead_capacity_frac=dead_capacity_frac, capacity=capacity,
                              loss=loss, loss_threshold=loss_threshold)
    for p in slow:
        health.report_slow(p, step)
    return slow


@dataclasses.dataclass
class CoSimResult:
    result: object  # the sweep's CompactResult
    outs: object  # its StepOutputs
    health: LinkHealth
    slow_paths: tuple[int, ...]
    plan: object  # the next PathPlan


def co_simulate(topo, plan, hosts, size_bytes: float, *, scheme: str = "ecmp",
                duration_s: float = 2e-3, health: LinkHealth | None = None,
                step: int = 0, overload: float = 1.5, capacity=None, device=None,
                **cfg_kw) -> CoSimResult:
    """One feedback cycle: plan -> trace -> simulation -> health -> next
    plan.  ``capacity`` takes the place of the topology's (one epoch of a
    fault schedule); the multi-epoch loop is ``dist.cosim.run_cosim``.
    ``device`` is the simulation's (None: the card)."""
    from repro_torch.netsim import sweep, workloads
    from repro_torch.netsim.engine import SimConfig

    # the ring cadence from the healthy uplinks' median, which a degraded
    # link (the one the co-simulation is there to find) does not move
    cap = capacity_vector(topo, capacity)
    link_bw = float(np.median(cap[np.asarray(topo.uplink_ids)]))
    trace = workloads.collective_trace(plan, hosts, size_bytes, link_bw=link_bw)
    cfg = SimConfig(scheme=scheme, duration_s=duration_s, **cfg_kw)
    result, outs = sweep.run_one(topo, cfg, trace, capacity=capacity, device=device)
    if health is None:
        health = LinkHealth(n_paths=topo.n_paths,
                            directions=tuple(plan.directions)
                            if len(plan.directions) == topo.n_paths else None)
    slow = report_congestion(health, topo, outs, step=step, overload=overload,
                             capacity=capacity)
    new_plan = health.plan(step, n_chunks=plan.n_chunks, wire_dtype=plan.wire_dtype)
    return CoSimResult(result=result, outs=outs, health=health, slow_paths=slow,
                       plan=new_plan)
