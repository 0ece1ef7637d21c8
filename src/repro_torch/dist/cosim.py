"""Multi-epoch co-simulation driver, the paper's Fig. 11 convergence story,
mirroring ``repro.dist.cosim``.

``dist.netfeed.co_simulate`` closes one plan -> trace -> simulation ->
health -> plan cycle.  ``run_cosim`` iterates it over a fault schedule
(spines killed at epoch k and back at k + m, brown-outs, chaos campaigns,
a degraded telemetry channel) and records each epoch's FCT, imbalance,
plan churn and quarantine in a ``CosimHistory``:

  epoch t:  capacity_t = capacity_at(topo, faults, t)     (fault state)
            trace_t    = collective_trace(plan_t, ...)    (the ring, ECMP-
                         steered so that plan_t's chunk -> path map binds)
            sim        = sweep.run_one(..., capacity=capacity_t)
            reports    = report_congestion(health, ..., step=t)
            plan_t+1   = health.plan(t + 1)               (a path re-enters
                         phi_steps after its last report)

Every epoch's simulation runs on the caller's device (the card unless the
caller passes ``device="cpu"``), through the compact engine and its tiered
cascade kernel every step.  The capacity is an operand of the run, so a
new fault state builds nothing (``EpochRecord.new_builds``, from
``sweep.cache_stats()``), and the ring cadence and the window (one slot
per flow, so nothing spills) are fixed at epoch 0, so every epoch's trace
has the same shapes.  The host reads each epoch's per-step outputs back
once (``sweep.run_one`` returns them as numpy), never once a step.

``run_cosim_grid`` runs a grid of specs through ``netsim.sweep.run_jobs``,
one callable job each.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
import time

import numpy as np

from repro_torch import resolve_device
from repro_torch.dist import collectives, netfeed
from repro_torch.dist.elastic import LinkHealth, StragglerPolicy, TelemetryWatchdog


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """The capacity of ``links`` is multiplied by ``scale`` for epochs in
    [start_epoch, end_epoch); ``end_epoch`` None never recovers.  Scale 0
    is a hard failure, 0 < scale < 1 a brown-out."""

    start_epoch: int
    links: tuple[int, ...]
    scale: float = 0.0
    end_epoch: int | None = None

    def __post_init__(self):
        # an event on no links, or one that ends before it starts, applies
        # to nothing and would read as a healthy fault epoch
        if not self.links:
            raise ValueError("a FaultEvent with no links does nothing")
        if self.start_epoch < 0 or self.scale < 0.0:
            raise ValueError(f"start_epoch {self.start_epoch} and scale {self.scale} "
                             "must be >= 0")
        if self.end_epoch is not None and self.end_epoch <= self.start_epoch:
            raise ValueError(f"end_epoch {self.end_epoch} <= start_epoch {self.start_epoch}")

    def active(self, epoch: int) -> bool:
        return self.start_epoch <= epoch and (self.end_epoch is None or epoch < self.end_epoch)


def kill_spine(topo, spine: int, *, epoch: int, recover_epoch: int | None = None) -> FaultEvent:
    """Fail one fabric switch (leaf_spine: a spine; three_tier: an
    aggregation switch; see ``topology.spine_links``)."""
    from repro_torch.netsim.topology import spine_links

    return FaultEvent(epoch, spine_links(topo, spine), 0.0, recover_epoch)


def brownout_spine(topo, spine: int, scale: float, *, epoch: int,
                   recover_epoch: int | None = None) -> FaultEvent:
    """Degrade one fabric switch's links to ``scale`` x capacity."""
    from repro_torch.netsim.topology import spine_links

    if not 0.0 < scale < 1.0:
        raise ValueError(f"a brown-out scale is in (0, 1), not {scale}")
    return FaultEvent(epoch, spine_links(topo, spine), scale, recover_epoch)


def capacity_at(topo, faults, epoch: int) -> np.ndarray:
    """The epoch's capacity vector f32[n_links + 1] (sentinel slot kept):
    the topology's, with every active fault applied."""
    cap = netfeed.capacity_vector(topo).astype(np.float32).copy()
    for ev in faults:
        if ev.active(epoch):
            cap[list(ev.links)] *= np.float32(ev.scale)
    return cap


def ring_hosts(topo, n: int) -> list[int]:
    """``n`` ring members striped across leaves (member i on leaf
    i % n_leaf): while n <= n_leaf, ring neighbours sit on different racks,
    so every ring segment crosses the fabric."""
    L, hpl = topo.n_leaf, topo.hosts_per_leaf
    if not 2 <= n <= topo.n_hosts:
        raise ValueError(f"a ring of {n} on {topo.n_hosts} hosts")
    return [(i % L) * hpl + (i // L) for i in range(n)]


@dataclasses.dataclass
class EpochRecord:
    """One planning epoch's observables.  FCTs are censored at the horizon
    (``metrics.fct_samples``): a killed spine starves flows, and a p99 of
    the finished flows alone would read that epoch as healthy."""

    epoch: int
    fct_p50_s: float
    fct_p99_s: float
    fct_mean_s: float
    completion: float
    imbalance_mean: float
    plan_churn: int  # inactive flags flipped between this plan and the next
    quarantined: tuple[int, ...]  # paths inactive in this epoch's plan
    reported_slow: tuple[int, ...]  # paths the feedback reported
    spill_steps: int
    new_builds: int  # kernel libraries built this epoch (sweep.cache_stats)
    fct: np.ndarray  # censored per-flow samples (CDFs)
    imbalance: np.ndarray  # per-(ToR, window) imbalance samples
    # chaos campaigns
    replan_round: int = -1  # the round in-epoch replanning cut at (-1: none)
    straggler_scale: float = 1.0  # the cadence stretch the ring paid
    straggler_quarantined: tuple[int, ...] = ()  # ranks the policy benched
    # degraded telemetry (-1 / False: no channel)
    safe_mode: bool = False  # the epoch ran on the blind ECMP fallback
    plan_version: int = -1  # the version of the plan in force
    reports_sent: int = -1
    reports_delivered: int = -1
    reports_admitted: int = -1
    reports_stale: int = -1
    reports_duplicate: int = -1
    # adaptive dt
    ff_steps: int = 0  # dt steps the fast-forward covered
    # the recorder (None: no RecordSpec)
    insim: dict | None = None  # obs.epoch_summary of the epoch's ring


@dataclasses.dataclass
class CosimHistory:
    """The driver's output: the epochs' records, the plans they ran, and
    the LinkHealth whose phi windows made them."""

    scheme: str
    phi_steps: int
    duration_s: float
    records: list[EpochRecord]
    plans: list  # the plan epoch t ran (len == epochs)
    final_plan: object  # the plan for epoch `epochs`
    health: LinkHealth
    plan_refused: int = 0  # newer plans that apply_plan refused (should be 0)

    @property
    def epochs(self) -> int:
        return len(self.records)

    def baseline_p99(self, fault_epoch: int) -> float:
        """The median censored p99 over the epochs before the first fault
        (epoch 0 if the fault hits at once)."""
        return float(np.median([r.fct_p99_s for r in self.records[:max(fault_epoch, 1)]]))

    def convergence_epoch(self, fault_epoch: int, tol: float = 0.10) -> int | None:
        """The first epoch >= ``fault_epoch`` whose censored p99 is back
        within ``tol`` of the baseline with every flow complete; None if
        none is."""
        base = self.baseline_p99(fault_epoch)
        for r in self.records[fault_epoch:]:
            if r.completion >= 1.0 and r.fct_p99_s <= (1.0 + tol) * base:
                return r.epoch
        return None

    def _records(self, epochs):
        return self.records if epochs is None else [r for r in self.records
                                                    if r.epoch in epochs]

    def fct_cdf(self, epochs: list[int] | None = None, points: int = 50):
        from repro_torch.netsim import metrics

        return metrics.cdf(np.concatenate([r.fct for r in self._records(epochs)]), points)

    def imbalance_cdf(self, epochs: list[int] | None = None, points: int = 50):
        from repro_torch.netsim import metrics

        rs = self._records(epochs)
        samples = (np.concatenate([r.imbalance for r in rs])
                   if any(r.imbalance.size for r in rs) else np.zeros(1))
        return metrics.cdf(samples, points)

    def as_record(self) -> dict:
        """JSON-able per-epoch curves."""
        rs = self.records
        return dict(
            scheme=self.scheme, phi_steps=self.phi_steps, epochs=self.epochs,
            duration_ms=round(self.duration_s * 1e3, 3),
            p50_us=[round(r.fct_p50_s * 1e6, 2) for r in rs],
            p99_us=[round(r.fct_p99_s * 1e6, 2) for r in rs],
            completion=[round(r.completion, 4) for r in rs],
            imbalance_mean=[round(r.imbalance_mean, 4) for r in rs],
            plan_churn=[r.plan_churn for r in rs],
            n_quarantined=[len(r.quarantined) for r in rs],
            spill_steps=[r.spill_steps for r in rs],
            new_builds=[r.new_builds for r in rs],
            replan_round=[r.replan_round for r in rs],
            straggler_scale=[round(r.straggler_scale, 3) for r in rs],
            n_straggler_quarantined=[len(r.straggler_quarantined) for r in rs],
            safe_mode=[bool(r.safe_mode) for r in rs],
            plan_version=[r.plan_version for r in rs],
            reports_sent=[r.reports_sent for r in rs],
            reports_delivered=[r.reports_delivered for r in rs],
            reports_admitted=[r.reports_admitted for r in rs],
            reports_stale=[r.reports_stale for r in rs],
            reports_duplicate=[r.reports_duplicate for r in rs],
        )

    def summary_lines(self) -> list[str]:
        return [f"epoch {r.epoch:2d} p99 {r.fct_p99_s * 1e6:8.1f}us "
                f"done {r.completion:5.3f} quar {len(r.quarantined):3d} "
                f"churn {r.plan_churn:3d} builds {r.new_builds}"
                for r in self.records]


# ------------------------------------------------------------ the journal
JOURNAL_SCHEMA_VERSION = 2
_TUPLES = ("quarantined", "reported_slow", "straggler_quarantined")


class JournalSchemaError(RuntimeError):
    """A journal of another schema version: raised rather than restarted
    over, since this driver could misparse its epochs.  A journal of
    another spec (another campaign) restarts silently."""


def _rec_to_json(r: EpochRecord) -> dict:
    d = dataclasses.asdict(r)
    d["fct"] = np.asarray(r.fct, np.float32).tolist()
    d["imbalance"] = np.asarray(r.imbalance, np.float32).tolist()
    for k in _TUPLES:
        d[k] = list(d[k])
    return d


def _rec_from_json(d: dict) -> EpochRecord:
    d = dict(d)
    d["fct"] = np.asarray(d["fct"], np.float32)
    d["imbalance"] = np.asarray(d["imbalance"], np.float32)
    for k in _TUPLES:
        d[k] = tuple(d.get(k, ()))
    return EpochRecord(**d)


def _load_journal(journal: str, spec_key: dict):
    """(records, epoch states) of a journal whose header has ``spec_key``;
    None for a missing, unreadable or other-spec file; raises
    ``JournalSchemaError`` for another schema version.  A torn last line
    (the run was cut while writing it) ends the valid prefix.  The last
    state is the driver's state to resume from."""
    if not os.path.exists(journal):
        return None
    try:
        with open(journal) as fh:
            raw = [ln for ln in fh if ln.strip()]
        head = json.loads(raw[0]) if raw else None
    except (OSError, ValueError):
        return None
    if not isinstance(head, dict) or head.get("journal") != "cosim":
        return None
    schema = head.get("schema_version", head.get("version"))
    if schema != JOURNAL_SCHEMA_VERSION:
        raise JournalSchemaError(
            f"cosim journal {journal!r} has schema_version={schema!r}, this driver "
            f"writes {JOURNAL_SCHEMA_VERSION}: delete it (the campaign restarts) or "
            "replay it with the driver that wrote it")
    if head.get("spec") != spec_key:
        return None
    records, states = [], []
    for ln in raw[1:]:
        try:
            d = json.loads(ln)
            records.append(_rec_from_json(d["record"]))
            states.append(d)
        except (ValueError, KeyError, TypeError):
            break
    return records, states


# ------------------------------------------------------------- the driver
def _steer_targets(plan, dead: set, n: int, n_chunks: int):
    """In-epoch replanning's steering targets [n_chunks, n]: before the
    cut, QP (chunk c, member i) steers to the plan's active path
    (i n_chunks + c) mod n_active; after it, only the QPs whose path died
    move, round-robin over the surviving paths (the primary path when none
    survives), so every other QP keeps its flow id and its path."""
    active = [p for p, d in enumerate(plan.inactive) if not d] or [0]
    before = np.array([[active[(i * n_chunks + c) % len(active)] for i in range(n)]
                       for c in range(n_chunks)], np.int32)
    surv = [p for p in active if p not in dead] or [0]
    after, k = before.copy(), 0
    for c in range(n_chunks):
        for i in range(n):
            if int(before[c, i]) in dead:
                after[c, i] = surv[k % len(surv)]
                k += 1
    return before, after


def _feedback(topo, outs, health, telemetry, staleness_bound, watchdog, epoch: int,
              overload: float, cap_report, loss):
    """The epoch's congestion reports into ``health``: directly (perfect
    channel), or through ``telemetry`` as epoch-stamped ``("slow", path)``
    reports plus one ``("hb", leaf)`` heartbeat a leaf, admitted against
    the staleness bound, with the watchdog fed the admissible count.
    Returns (reported paths, (sent, delivered, admitted, stale,
    duplicate)), the counts -1 without a channel."""
    if telemetry is None:
        slow = netfeed.report_congestion(health, topo, outs, step=epoch, overload=overload,
                                         capacity=cap_report, loss=loss)
        return slow, (-1, -1, -1, -1, -1)
    observed = netfeed.observe_congestion(topo, outs, overload=overload, capacity=cap_report,
                                          loss=loss)
    for p in observed:
        telemetry.send(("slow", int(p)), epoch)
    for leaf in range(topo.n_leaf):
        telemetry.send(("hb", int(leaf)), epoch)
    batch = telemetry.deliver(epoch)
    admitted = stale = dup = 0
    admitted_slow: list[int] = []
    for payload, origin in batch:
        if payload[0] == "slow":
            verdict = health.admit_report(int(payload[1]), origin, epoch)
            if verdict == "admitted":
                admitted += 1
                admitted_slow.append(int(payload[1]))
            elif verdict == "stale":
                stale += 1
            else:
                dup += 1
        elif staleness_bound is not None and epoch - origin > staleness_bound:
            stale += 1  # a heartbeat passes the same staleness gate
        else:
            admitted += 1
    watchdog.observe(admitted)
    counts = (len(observed) + topo.n_leaf, len(batch), admitted, stale, dup)
    return tuple(dict.fromkeys(admitted_slow)), counts


def run_cosim(topo, hosts, size_bytes: float, *, scheme: str = "ecmp", epochs: int = 8,
              faults: tuple = (), campaign=None, phi_steps: int = 2, cooldown_steps: int = 0,
              n_chunks: int = 8, wire_dtype: str = "float32", dt: float = 10e-6,
              duration_s: float | None = None, overload: float = 1.5, steer: bool = True,
              replan: bool = True, detect_delay_s: float | None = None,
              health: LinkHealth | None = None, straggler_policy=None,
              straggler_deadline_frac: float = 1.5, seed: int = 0,
              window_slots: int | None = None, imbalance_sample_every: int = 10,
              journal: str | None = None, telemetry=None, staleness_bound: int | None = None,
              blackout_epochs: int = 3, record=None, flight=None, flowcells: int = 1,
              reorder_budget: float | None = None, device=None, **cfg_kw) -> CosimHistory:
    """Run ``epochs`` plan -> simulation -> health cycles over a fault
    schedule, each epoch's simulation on ``device`` (None: the card).

    ``hosts`` are the ring members (``ring_hosts``), ``size_bytes`` each
    member's all-reduce payload.  The ring cadence comes from the healthy
    topology: a round every max(a segment's serialization on the fabric,
    n_chunks segments on the host NIC).  ``window_slots`` defaults to one
    slot per flow, so that no epoch can spill.

    Chaos campaigns (``campaign``, a ``netsim.faults.FaultCampaign``): each
    epoch's wall-clock capacity schedule f32[K, n_links + 1] and loss
    vector go to the simulation as operands (``faults`` compose on top);
    under adaptive dt the schedule's stride is aligned to the engine's
    chunk.  In-epoch replanning (``replan``, with ``steer``): a flap with
    an onset inside the epoch is detected ``detect_delay_s`` (default two
    ring rounds) later; rounds before the cut run the plan, rounds after
    it a ``collectives.replan_chunk_paths`` pinned plan, in which only the
    QPs whose path died re-steer.  Stragglers stretch their rank's step;
    ``straggler_policy`` (made when the campaign has stragglers) benches
    ranks, which then stop gating the cadence.  ``cooldown_steps`` turns on
    LinkHealth's flap hysteresis.  ``journal`` (a path) gets one JSON line
    an epoch; a rerun with the same spec resumes after its last complete
    epoch (a torn last line is dropped; another spec restarts, another
    schema version raises ``JournalSchemaError``).

    Degraded telemetry (``telemetry``, a ``netsim.faults.TelemetryChannel``;
    None is the perfect channel): reports and heartbeats cross the channel
    and are admitted against ``staleness_bound``; plans apply through
    ``collectives.apply_plan`` (versions strictly increase, a replayed
    older plan is refused, which is checked every epoch, and refused newer
    plans are counted); a ``TelemetryWatchdog`` puts the driver in safe
    mode (all paths active, no steering) after ``blackout_epochs`` silent
    epochs, and one admissible delivery takes it out.

    ``record`` (an ``obs.RecordSpec``) runs the recorder in every epoch and
    puts ``obs.epoch_summary`` of its ring on ``EpochRecord.insim``.
    ``flight`` (a path, or an open ``obs.FlightLog``) gets a ``campaign``
    event, one ``epoch`` event an epoch and a ``run_end`` event.
    ``flowcells`` > 1 sprays every chunk's cells over the active paths,
    and ``reorder_budget`` (packets, or None) charges their reordering."""
    from repro_torch.netsim import compact, metrics, sweep, workloads
    from repro_torch.netsim.engine import SimConfig

    device = resolve_device(device)
    topo = topo.to(device)
    hosts = list(hosts)
    n = len(hosts)
    if health is None:
        health = LinkHealth(n_paths=topo.n_paths, phi_steps=phi_steps,
                            cooldown_steps=cooldown_steps, max_staleness_epochs=staleness_bound)
    else:
        phi_steps = health.phi_steps
    watchdog = (TelemetryWatchdog(blackout_epochs=blackout_epochs)
                if telemetry is not None else None)

    cap0 = netfeed.capacity_vector(topo)
    fabric_bw = float(np.median(cap0[np.asarray(topo.uplink_ids)]))
    host_bw = float(cap0[topo.n_links - 2 * topo.n_hosts])
    seg_bytes = size_bytes / (n * n_chunks)
    # a member serializes all n_chunks segments of a round through one NIC
    gap = max(seg_bytes * 8.0 / fabric_bw, n_chunks * seg_bytes * 8.0 / host_bw)
    rounds = 2 * (n - 1)
    if duration_s is None:
        duration_s = rounds * gap * 2.5 + 50 * dt
    n_steps = max(int(math.ceil(duration_s / dt)), 1)
    duration_s = n_steps * dt
    cfg = SimConfig(scheme=scheme, duration_s=duration_s, dt=dt, **cfg_kw)

    policy = straggler_policy
    if policy is None and campaign is not None and campaign.has_stragglers():
        policy = StragglerPolicy(deadline_s=gap * straggler_deadline_frac, max_misses=2)

    start_epoch = 0
    records: list[EpochRecord] = []
    plans: list = []
    spec_key = dict(
        scheme=scheme, epochs=epochs, hosts=[int(h) for h in hosts],
        size_bytes=float(size_bytes), phi_steps=phi_steps, cooldown_steps=cooldown_steps,
        n_chunks=n_chunks, seed=seed, steer=bool(steer), replan=bool(replan),
        topo=dict(kind=topo.kind, n_links=topo.n_links, n_paths=topo.n_paths),
        telemetry=None if telemetry is None else telemetry.config(),
        staleness_bound=staleness_bound,
        blackout_epochs=blackout_epochs if telemetry is not None else None,
    )
    if record is not None:  # the key exists only when used, as in the reference
        spec_key["record"] = dict(ring_chunks=int(record.ring_chunks),
                                  quantiles=[float(q) for q in record.quantiles])
    if flowcells != 1 or reorder_budget is not None:
        spec_key["flowcell"] = dict(
            flowcells=int(flowcells),
            reorder_budget=None if reorder_budget is None else float(reorder_budget))

    def _fc(p):
        # the split stamped on the plans the driver runs (copies: health and
        # the journal keep the unstamped ones)
        return dataclasses.replace(p, flowcells=int(flowcells)) if flowcells != 1 else p

    journal_fh = None
    if journal is not None:
        loaded = _load_journal(journal, spec_key)
        states = loaded[1] if loaded is not None else []
        if loaded is not None:
            records = loaded[0]
            start_epoch = len(records)
            if states:
                last = states[-1]
                health.restore(last["health"])
                for part, st in ((policy, "straggler"), (telemetry, "telemetry"),
                                 (watchdog, "watchdog")):
                    if part is not None and last.get(st):
                        part.restore(last[st])
            plans = [collectives.PathPlan(
                n_chunks=n_chunks, directions=tuple(health.directions),
                inactive=tuple(bool(b) for b in st["plan_inactive"]), wire_dtype=wire_dtype,
                version=int(st["record"].get("plan_version", 0))) for st in states]
        # rewrite the header and the valid prefix: a torn last line goes
        journal_fh = open(journal, "w")
        journal_fh.write(json.dumps(dict(journal="cosim", schema_version=JOURNAL_SCHEMA_VERSION,
                                         spec=spec_key)) + "\n")
        for st in states:
            journal_fh.write(json.dumps(st) + "\n")
        journal_fh.flush()

    fl, fl_owned = None, False
    if flight is not None:
        from repro_torch.obs import FlightLog

        fl_owned = not isinstance(flight, FlightLog)
        fl = FlightLog(flight, meta=dict(spec=spec_key)) if fl_owned else flight
        fl.event("campaign", scheme=scheme, epochs=epochs, start_epoch=start_epoch, n_hosts=n,
                 size_bytes=float(size_bytes), n_steps=n_steps, duration_s=duration_s, dt=dt,
                 n_chunks=n_chunks,
                 n_faults=len(faults) + (len(campaign.events) if campaign is not None else 0),
                 telemetry=spec_key["telemetry"], record=spec_key.get("record"))

    plan = health.plan(start_epoch, n_chunks=n_chunks, wire_dtype=wire_dtype)
    plan_refused = 0
    W = window_slots
    try:
        for epoch in range(start_epoch, epochs):
            t_ep = time.time()
            # the watchdog's state entering the epoch decides its conduct: a
            # blind planner runs every path active, unsteered
            in_safe = watchdog is not None and watchdog.safe_mode
            run_plan = (collectives.PathPlan(n_chunks=n_chunks,
                                             directions=tuple(health.directions),
                                             wire_dtype=wire_dtype, version=plan.version)
                        if in_safe else plan)

            if campaign is not None:
                cap = campaign.capacity_schedule(topo, epoch)  # [K, n_links + 1]
                for ev in faults:
                    if ev.active(epoch):
                        cap[:, list(ev.links)] *= np.float32(ev.scale)
                # adaptive dt: segment edges on the chunk grid, where the
                # quiescence check can fast-forward
                K_chunk = compact.plan_chunks(cfg, n_steps)[0]
                cap_seg = campaign.seg_steps(n_steps, align=K_chunk if cfg.adaptive else 1)
                loss = campaign.loss_at(topo, epoch)
                # reports see the epoch's worst capacity: a link that flapped
                # at all reads as degraded
                cap_report = cap.min(axis=0)
                slowdowns = campaign.straggler_slowdowns(epoch)
            else:
                cap = capacity_at(topo, faults, epoch)
                cap_seg, loss, cap_report, slowdowns = 0, None, cap, {}

            strag_quar: tuple[int, ...] = ()
            if policy is not None:
                for i in range(n):
                    policy.observe(i, gap * slowdowns.get(i, 1.0))
                strag_quar = policy.quarantined()
            # the slowest rank that is not benched gates the ring
            eff = max([slowdowns.get(i, 1.0) for i in range(n) if i not in strag_quar] or [1.0])
            gap_e = gap * eff

            steer_p = topo.n_paths if steer and not in_safe else None
            onset = campaign.midepoch_onset(topo, epoch) if campaign else None
            replan_round = -1
            if onset is not None and replan and steer and not in_safe and onset.paths:
                t_detect = onset.frac * duration_s + (
                    detect_delay_s if detect_delay_s is not None else 2 * gap_e)
                r_cut = int(math.ceil(t_detect / gap_e))
                if 0 < r_cut < rounds:
                    replan_round = r_cut
            ring = dict(link_bw=fabric_bw, round_gap_s=gap_e, seed=seed, steer_paths=steer_p)
            if replan_round > 0:
                # seen mid-collective: reported now, so that both this
                # epoch's tail and the next plan route around it
                for p in onset.paths:
                    health.report_slow(p, epoch)
                inact2 = tuple(d or p in set(onset.paths) for p, d in enumerate(plan.inactive))
                pinned = collectives.PinnedPlan(
                    n_chunks=n_chunks, directions=tuple(plan.directions), inactive=inact2,
                    paths=collectives.replan_chunk_paths(plan.chunk_paths(),
                                                         tuple(plan.directions), inact2),
                    wire_dtype=wire_dtype)
                tgt, tgt_b = _steer_targets(plan, set(onset.paths), n, n_chunks)
                tr_a = workloads.collective_trace(_fc(plan), hosts, size_bytes,
                                                  rounds=replan_round, steer_targets=tgt, **ring)
                tr_b = workloads.collective_trace(_fc(pinned), hosts, size_bytes,
                                                  rounds=rounds - replan_round,
                                                  start_s=replan_round * gap_e,
                                                  steer_targets=tgt_b, **ring)
                trace = workloads.merge_traces(tr_a, tr_b)
            else:
                trace = workloads.collective_trace(_fc(run_plan), hosts, size_bytes, **ring)
            if W is None:
                W = int(trace.valid.sum())  # one slot per flow: nothing spills

            b0 = sweep.cache_stats()["builds"]
            result, outs = sweep.run_one(topo, cfg, trace, capacity=cap, loss=loss,
                                         cap_seg_steps=cap_seg, window_slots=W, record=record,
                                         reorder=reorder_budget, device=device)
            new_builds = sweep.cache_stats()["builds"] - b0
            insim = None
            if record is not None and result.ring is not None:
                from repro_torch import obs

                insim = obs.epoch_summary(record, obs.drain(record, result.ring))

            slow, (n_sent, n_delivered, n_admitted, n_stale, n_dup) = _feedback(
                topo, outs, health, telemetry, staleness_bound, watchdog, epoch, overload,
                cap_report, loss)

            next_plan = health.plan(epoch + 1, n_chunks=n_chunks, wire_dtype=wire_dtype)
            applied, took = collectives.apply_plan(plan, next_plan)
            if not took:
                plan_refused += 1  # a newer plan refused: a fault of the driver
            # the no-reordering rule across versions, checked live: an older
            # or a repeated delivery is refused and leaves the table as it is
            for replay in (plan, applied):
                kept, took_replay = collectives.apply_plan(applied, replay)
                if kept is not applied or took_replay:
                    raise RuntimeError(f"apply_plan took version {replay.version} over "
                                       f"{applied.version}")
            churn = sum(int(a != b) for a, b in zip(plan.inactive, applied.inactive))
            fct, completion = metrics.fct_samples(result, trace, horizon_s=duration_s)
            imb = metrics.throughput_imbalance(outs, sample_every=imbalance_sample_every,
                                               trace_stride=cfg.uplink_sample_every)
            rec = EpochRecord(
                epoch=epoch, fct_p50_s=float(np.percentile(fct, 50)),
                fct_p99_s=float(np.percentile(fct, 99)), fct_mean_s=float(fct.mean()),
                completion=completion, imbalance_mean=float(imb.mean()) if imb.size else 0.0,
                plan_churn=churn,
                quarantined=tuple(p for p, d in enumerate(run_plan.inactive) if d),
                reported_slow=tuple(slow), spill_steps=int(result.spill_steps),
                new_builds=new_builds, fct=fct, imbalance=imb, replan_round=replan_round,
                straggler_scale=float(eff), straggler_quarantined=strag_quar,
                safe_mode=in_safe, plan_version=int(plan.version), reports_sent=n_sent,
                reports_delivered=n_delivered, reports_admitted=n_admitted,
                reports_stale=n_stale, reports_duplicate=n_dup,
                ff_steps=int(result.ff_steps), insim=insim)
            records.append(rec)
            plans.append(run_plan)
            if journal_fh is not None:
                journal_fh.write(json.dumps(dict(
                    epoch=epoch, record=_rec_to_json(rec),
                    plan_inactive=[bool(b) for b in run_plan.inactive],
                    health=health.state(),
                    straggler=policy.state() if policy is not None else None,
                    telemetry=telemetry.state() if telemetry is not None else None,
                    watchdog=watchdog.state() if watchdog is not None else None)) + "\n")
                journal_fh.flush()
            if fl is not None:
                fa = list(campaign.activations(epoch)) if campaign else []
                fa += [dict(kind="FaultEvent", links=list(ev.links), scale=ev.scale,
                            start_epoch=ev.start_epoch, end_epoch=ev.end_epoch)
                       for ev in faults if ev.active(epoch)]
                fl.event(
                    "epoch", epoch=epoch, t0_s=t_ep, dur_s=time.time() - t_ep,
                    n_steps=n_steps, fct_p50_us=round(rec.fct_p50_s * 1e6, 3),
                    fct_p99_us=round(rec.fct_p99_s * 1e6, 3), completion=round(completion, 5),
                    plan_version=int(run_plan.version), plan_churn=churn, safe_mode=in_safe,
                    replan_round=replan_round, quarantined=[int(p) for p in rec.quarantined],
                    reported_slow=[int(p) for p in rec.reported_slow],
                    straggler_quarantined=[int(i) for i in strag_quar],
                    straggler_scale=float(eff), new_builds=new_builds,
                    spill_steps=int(result.spill_steps), ff_steps=rec.ff_steps,
                    reports=None if telemetry is None else dict(
                        sent=n_sent, delivered=n_delivered, admitted=n_admitted,
                        stale=n_stale, duplicate=n_dup),
                    watchdog=watchdog.state() if watchdog is not None else None,
                    sweep=sweep.obs_stats(),
                    hot_uplinks=netfeed.hot_uplinks(topo, outs, capacity=cap_report),
                    faults=fa, insim=insim)
            plan = applied
        hist = CosimHistory(scheme=scheme, phi_steps=phi_steps, duration_s=duration_s,
                            records=records, plans=plans, final_plan=plan, health=health,
                            plan_refused=plan_refused)
        if fl is not None and records:
            evs = list(faults) + (list(campaign.events) if campaign else [])
            fe = min((f.start_epoch for f in evs), default=1)
            fl.event("run_end", epochs_run=len(records),
                     convergence_epoch=hist.convergence_epoch(fe), plan_refused=plan_refused,
                     total_new_builds=sum(r.new_builds for r in records),
                     sweep=sweep.obs_stats())
    finally:
        if journal_fh is not None:
            journal_fh.close()
        if fl is not None and fl_owned:
            fl.close()
    return hist


def run_cosim_grid(specs: list[dict], *, workers: int = 1, salvage: bool = False,
                   timeout_s: float | None = None, retries: int = 0, device=None) -> list:
    """One ``run_cosim`` loop per spec dict, as callable jobs of
    ``netsim.sweep.run_jobs``; histories come back in spec order.  A spec
    without a ``device`` runs on ``device`` (None: the card).  With
    ``salvage=True`` a spec that raises or times out gives a
    ``sweep.JobFailure`` at its index (``getattr(h, "failed", False)``).

    With ``workers > 1`` the loops run on threads that share the device,
    the kernels' launch counters and ``sweep.cache_stats``, so a history's
    ``new_builds`` may count another loop's builds; on one device the
    loops' results do not depend on how they interleave (the kernels' sums
    do not depend on the order of their additions)."""
    from repro_torch.netsim import sweep

    device = resolve_device(device)
    return sweep.run_jobs([functools.partial(run_cosim, **{"device": device, **spec})
                           for spec in specs], workers=workers, device=device,
                          salvage=salvage, timeout_s=timeout_s, retries=retries)
