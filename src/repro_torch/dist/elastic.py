"""Path and pod health, mirroring ``repro.dist.elastic`` (plain Python over
the port's ``collectives``): the phi-window quarantine ``LinkHealth``, the
telemetry ``TelemetryWatchdog``, the pod ``remesh_plan`` and the
``StragglerPolicy``.

``LinkHealth`` is the host-side mirror of the paper's source-ToR
Congestion Table: a path reported slow stays quarantined for ``phi_steps``
steps (each new report refreshes the window, as the table's phi timer
does), and ``plan()`` bakes the current quarantine set into a
``PathPlan`` so the next collective routes around it.  Reports come from
wherever congestion is observed: straggling collective timings in a
deployment, or the fluid simulator through ``dist.netfeed`` in the
co-simulation loop.
"""
from __future__ import annotations

import dataclasses

from repro_torch.dist import collectives


def alternating_directions(n_paths: int) -> tuple[int, ...]:
    """Default ring directions: adjacent paths run opposite ways, so the
    two directions of a host link are driven alike."""
    return tuple(1 if p % 2 == 0 else -1 for p in range(n_paths))


@dataclasses.dataclass
class LinkHealth:
    """Per-path quarantine with a refreshing phi window (in steps): a path
    is inactive at ``step`` iff a slowness report arrived strictly fewer
    than its phi steps ago.

    Hysteresis (``cooldown_steps > 0``): a path re-reported within
    ``cooldown_steps`` of its window's expiry is flapping; its phi doubles
    (capped at ``max_phi_steps`` when > 0), while a report well after the
    cooldown resets it to ``phi_steps``.  ``cooldown_steps=0`` keeps
    ``expiry == last_report + phi_steps``, which the co-sim's release epoch
    keys on.

    ``admit_report`` admits epoch-stamped reports from a lossy, delayed
    channel: older than ``max_staleness_epochs`` is discarded, and a
    repeated (path, origin) report is idempotent.  ``None`` admits any
    age."""

    n_paths: int
    phi_steps: int = 16
    directions: tuple[int, ...] | None = None
    cooldown_steps: int = 0
    max_phi_steps: int = 0  # 0 = uncapped
    max_staleness_epochs: int | None = None

    def __post_init__(self):
        if self.n_paths < 1 or self.phi_steps < 1:
            raise ValueError(f"n_paths {self.n_paths} and phi_steps {self.phi_steps} "
                             "must be >= 1")
        if self.cooldown_steps < 0 or self.max_phi_steps < 0:
            raise ValueError("cooldown_steps and max_phi_steps must be >= 0")
        # a cap below the base window would let hysteresis shorten quarantines
        if self.max_phi_steps and self.max_phi_steps < self.phi_steps:
            raise ValueError(f"max_phi_steps {self.max_phi_steps} < phi_steps "
                             f"{self.phi_steps}")
        if self.max_staleness_epochs is not None and self.max_staleness_epochs < 0:
            raise ValueError(f"max_staleness_epochs {self.max_staleness_epochs} < 0")
        if self.directions is None:
            self.directions = alternating_directions(self.n_paths)
        if len(self.directions) != self.n_paths:
            raise ValueError(f"{len(self.directions)} directions for {self.n_paths} paths")
        self._last_report: dict[int, int] = {}
        self._phi: dict[int, int] = {}  # per-path effective phi (hysteresis)
        self._seen: set[tuple[int, int]] = set()  # (path, origin) admitted

    def phi_of(self, path: int) -> int:
        """The effective phi window of ``path``."""
        return self._phi.get(path, self.phi_steps)

    def report_slow(self, path: int, step: int) -> None:
        if not 0 <= path < self.n_paths:
            raise ValueError(f"path {path} outside [0, {self.n_paths})")
        prev = self._last_report.get(path)
        if prev is not None and self.cooldown_steps > 0:
            prev_expiry = prev + self.phi_of(path)
            if prev_expiry <= step < prev_expiry + self.cooldown_steps:
                # released and slow again within the cooldown: a flapper
                new_phi = self.phi_of(path) * 2
                if self.max_phi_steps > 0:
                    new_phi = min(new_phi, self.max_phi_steps)
                self._phi[path] = new_phi
            elif step >= prev_expiry + self.cooldown_steps:
                self._phi[path] = self.phi_steps  # a clean recovery
        self._last_report[path] = step if prev is None else max(prev, step)

    def admit_report(self, path: int, origin_epoch: int, now_epoch: int) -> str:
        """Admit one report about congestion observed at ``origin_epoch``,
        delivered at ``now_epoch``: ``"stale"`` (older than the bound;
        discarded), ``"duplicate"`` (this (path, origin) was admitted
        already; discarded, so a duplicated delivery neither refreshes the
        window nor trips hysteresis) or ``"admitted"`` (the window refreshes
        from the delivery epoch).  A late report never shortens a window:
        ``report_slow`` keeps the newest step."""
        if not 0 <= origin_epoch <= now_epoch:
            raise ValueError(f"origin epoch {origin_epoch} after delivery {now_epoch}")
        if (self.max_staleness_epochs is not None
                and now_epoch - origin_epoch > self.max_staleness_epochs):
            return "stale"
        key = (path, origin_epoch)
        if key in self._seen:
            return "duplicate"
        self._seen.add(key)
        self.report_slow(path, now_epoch)
        return "admitted"

    def inactive(self, step: int) -> tuple[bool, ...]:
        return tuple(self._last_report.get(p) is not None
                     and step < self._last_report[p] + self.phi_of(p)
                     for p in range(self.n_paths))

    def expiry(self, path: int) -> int | None:
        """The first step at which ``path`` re-enters ``plan()``: its
        effective phi after its last report; None if never reported."""
        last = self._last_report.get(path)
        return None if last is None else last + self.phi_of(path)

    def state(self) -> dict:
        """A JSON-able snapshot for the co-sim's journal."""
        return dict(last_report={str(k): v for k, v in self._last_report.items()},
                    phi={str(k): v for k, v in self._phi.items()},
                    seen=sorted(list(k) for k in self._seen))

    def restore(self, state: dict) -> None:
        self._last_report = {int(k): int(v) for k, v in state.get("last_report", {}).items()}
        self._phi = {int(k): int(v) for k, v in state.get("phi", {}).items()}
        self._seen = {(int(p), int(e)) for p, e in state.get("seen", [])}

    def plan(self, step: int, n_chunks: int = 4, wire_dtype: str = "float32",
             version: int | None = None) -> collectives.PathPlan:
        """A PathPlan that avoids the paths quarantined at ``step``;
        ``version`` defaults to ``step``, so successive planning epochs make
        increasing versions, as ``apply_plan`` needs."""
        return collectives.PathPlan(n_chunks=n_chunks, directions=tuple(self.directions),
                                    inactive=self.inactive(step), wire_dtype=wire_dtype,
                                    version=step if version is None else version)


@dataclasses.dataclass
class TelemetryWatchdog:
    """Blackout detector for the congestion-feedback channel: after
    ``blackout_epochs`` planning epochs in a row with no admissible
    delivery (report or heartbeat) the planner stops steering on stale
    state and falls back to plain ECMP (safe mode); one admissible
    delivery recovers it.  ``observe`` returns the transition taken:
    "ok", "silent" (counting down), "safe" (in or entering safe mode) or
    "recovered"."""

    blackout_epochs: int = 3

    def __post_init__(self):
        if self.blackout_epochs < 1:
            raise ValueError(f"blackout_epochs {self.blackout_epochs} < 1")
        self._silent = 0
        self._safe = False
        # how often each transition fired over the run, for the flight log
        self._transitions = {"ok": 0, "silent": 0, "safe": 0, "recovered": 0}

    @property
    def safe_mode(self) -> bool:
        return self._safe

    def silent_epochs(self) -> int:
        return self._silent

    def observe(self, n_admissible: int) -> str:
        """Feed one epoch's count of admissible deliveries."""
        if n_admissible < 0:
            raise ValueError(f"n_admissible {n_admissible} < 0")
        if n_admissible > 0:
            self._silent = 0
            verdict = "recovered" if self._safe else "ok"
            self._safe = False
        else:
            self._silent += 1
            if self._silent >= self.blackout_epochs:
                self._safe = True
            verdict = "safe" if self._silent >= self.blackout_epochs else "silent"
        self._transitions[verdict] += 1
        return verdict

    def state(self) -> dict:
        """A JSON-able snapshot for the co-sim's journal."""
        return dict(silent=self._silent, safe=self._safe, transitions=dict(self._transitions))

    def restore(self, state: dict) -> None:
        self._silent = int(state.get("silent", 0))
        self._safe = bool(state.get("safe", False))
        t = state.get("transitions")
        if t:
            self._transitions = {k: int(t.get(k, 0)) for k in self._transitions}


@dataclasses.dataclass(frozen=True)
class RemeshPlan:
    new_shape: tuple[int, ...]
    surviving_pods: tuple[int, ...]
    per_pod_batch_scale: float
    resume_step: int


def remesh_plan(mesh_shape: tuple[int, ...], failed_pods: tuple[int, ...],
                resume_step: int) -> RemeshPlan:
    """Shrink the pod axis around failed pods, keeping the global batch:
    each survivor takes ``n_pods / n_survivors`` of the per-pod batch, and
    training resumes from the checkpoint at ``resume_step``."""
    n_pods = mesh_shape[0]
    failed = set(failed_pods)
    if not all(0 <= p < n_pods for p in failed):
        raise ValueError(f"failed pods {failed_pods} outside [0, {n_pods})")
    surviving = tuple(p for p in range(n_pods) if p not in failed)
    if not surviving:
        raise RuntimeError(f"all {n_pods} pods failed: nothing to remesh onto")
    return RemeshPlan(new_shape=(len(surviving),) + tuple(mesh_shape[1:]),
                      surviving_pods=surviving, per_pod_batch_scale=n_pods / len(surviving),
                      resume_step=resume_step)


@dataclasses.dataclass
class StragglerPolicy:
    """Deadline watchdog: ``max_misses`` over-deadline steps in a row
    quarantine a rank, one on-time step recovers it.  The co-sim feeds it
    every rank's step duration each epoch; ``quarantined()`` are the ranks
    the bulk-synchronous cadence stops waiting for."""

    deadline_s: float
    max_misses: int = 3

    def __post_init__(self):
        if not (self.deadline_s > 0 and self.max_misses >= 1):
            raise ValueError(f"deadline_s {self.deadline_s} and max_misses "
                             f"{self.max_misses} must be positive")
        self._misses: dict[int, int] = {}
        self._quarantined: set[int] = set()

    def observe(self, rank: int, step_duration_s: float) -> str:
        if step_duration_s <= self.deadline_s:
            self._misses[rank] = 0
            self._quarantined.discard(rank)
            return "ok"
        misses = self._misses.get(rank, 0) + 1
        self._misses[rank] = misses
        if misses >= self.max_misses:
            self._quarantined.add(rank)
            return "quarantine"
        return "warn"

    def misses(self, rank: int) -> int:
        return self._misses.get(rank, 0)

    def quarantined(self) -> tuple[int, ...]:
        return tuple(sorted(self._quarantined))

    def state(self) -> dict:
        """A JSON-able snapshot for the co-sim's journal."""
        return dict(misses={str(k): v for k, v in self._misses.items()},
                    quarantined=sorted(self._quarantined))

    def restore(self, state: dict) -> None:
        self._misses = {int(k): int(v) for k, v in state.get("misses", {}).items()}
        self._quarantined = {int(r) for r in state.get("quarantined", [])}
