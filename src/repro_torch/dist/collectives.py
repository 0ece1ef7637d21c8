"""The multipath plan of a SeqBalance collective, host side, mirroring
``repro.dist.collectives``: the gradient bucket is cut into ``n_chunks``
chunks, and each chunk runs its own ring in its path's direction;
quarantined paths are skipped by the round-robin chunk -> path map, so
in-flight chunks never move.  With ``flowcells > 1`` each chunk is cut
further into token cells sprayed over the active paths (the reordering
the paper's rule avoids), and ``reorder_budget`` is the NIC's out-of-order
absorption in packets, the simulator's ``reorder`` operand.

Here: ``PathPlan`` (with its wire dtype and version), ``PinnedPlan`` (an
explicit chunk -> path table, the output of in-epoch replanning),
``apply_plan`` (the no-reordering rule across plan versions) and
``replan_chunk_paths``.  The ring all-reduce itself over
``torch.distributed``, its wire encodings and ``sharding`` are not ported
yet.
"""
from __future__ import annotations

import dataclasses

WIRE_DTYPES = ("float32", "bfloat16", "int8")


def _active(inactive) -> list[int]:
    """The paths not quarantined; with every path quarantined, the primary
    path (traffic must still flow)."""
    return [p for p, dead in enumerate(inactive) if not dead] or [0]


def _check_cells(flowcells: int, reorder_budget: float) -> None:
    if flowcells < 1:
        raise ValueError(f"flowcells {flowcells} < 1")
    if not reorder_budget >= 0.0:
        raise ValueError(f"reorder_budget {reorder_budget} < 0")


@dataclasses.dataclass(frozen=True)
class PathPlan:
    """``directions`` holds one ring direction (+1 / -1) per path;
    ``inactive`` flags the paths that congestion feedback quarantined.
    ``wire_dtype`` is the chunks' dtype on the wire; ``version`` the plan's
    monotone generation number (the planning epoch that made it), which
    ``apply_plan`` compares.  ``flowcells`` cuts each chunk into that many
    equal cells round-robined over the active paths (``flowcell_paths``);
    1 is the classic plan.  ``reorder_budget`` (packets, >= 0) rides along
    to the simulator."""

    n_chunks: int = 4
    directions: tuple[int, ...] = (1, -1)
    inactive: tuple[bool, ...] | None = None
    wire_dtype: str = "float32"
    version: int = 0
    flowcells: int = 1
    reorder_budget: float = 0.0

    def __post_init__(self):
        if self.n_chunks < 1:
            raise ValueError(f"n_chunks {self.n_chunks} < 1")
        if any(d not in (1, -1) for d in self.directions):
            raise ValueError(f"directions {self.directions} are not all +1 / -1")
        if self.inactive is None:
            object.__setattr__(self, "inactive", (False,) * len(self.directions))
        if len(self.inactive) != len(self.directions):
            raise ValueError("inactive and directions differ in length")
        if self.wire_dtype not in WIRE_DTYPES:
            raise ValueError(f"wire_dtype {self.wire_dtype!r} not in {WIRE_DTYPES}")
        _check_cells(self.flowcells, self.reorder_budget)

    @property
    def n_paths(self) -> int:
        return len(self.directions)

    def chunk_paths(self) -> tuple[int, ...]:
        """Round-robin chunk -> path assignment over the active paths."""
        active = _active(self.inactive)
        return tuple(active[c % len(active)] for c in range(self.n_chunks))

    def flowcell_paths(self) -> tuple[tuple[int, ...], ...]:
        """Per-chunk flowcell -> path table: chunk c's cell j rides
        ``active[(c + j) % n_active]``.  Cell 0 keeps the chunk's
        round-robin path, so ``flowcells=1`` is ``chunk_paths`` exactly."""
        active = _active(self.inactive)
        return tuple(tuple(active[(c + j) % len(active)] for j in range(self.flowcells))
                     for c in range(self.n_chunks))


@dataclasses.dataclass(frozen=True)
class PinnedPlan:
    """A plan whose chunk -> path table is explicit (``paths[c]``), the
    output of in-epoch replanning (``replan_chunk_paths``).  It has
    ``PathPlan``'s fields and methods, so whatever reads a plan
    (``workloads.collective_trace``) takes it, but ``chunk_paths()``
    returns the pinned table as it is."""

    n_chunks: int
    directions: tuple[int, ...]
    inactive: tuple[bool, ...]
    paths: tuple[int, ...]
    wire_dtype: str = "float32"
    version: int = 0
    flowcells: int = 1
    reorder_budget: float = 0.0

    def __post_init__(self):
        if len(self.paths) != self.n_chunks:
            raise ValueError(f"{len(self.paths)} pinned paths for {self.n_chunks} chunks")
        if len(self.inactive) != len(self.directions):
            raise ValueError("inactive and directions differ in length")
        if not all(0 <= p < len(self.directions) for p in self.paths):
            raise ValueError(f"pinned paths {self.paths} outside [0, {len(self.directions)})")
        _check_cells(self.flowcells, self.reorder_budget)

    @property
    def n_paths(self) -> int:
        return len(self.directions)

    def chunk_paths(self) -> tuple[int, ...]:
        return tuple(self.paths)

    def flowcell_paths(self) -> tuple[tuple[int, ...], ...]:
        """Cell 0 keeps the pinned path (replanning chose it); later cells
        walk the active paths from the pinned one."""
        active = _active(self.inactive)
        out = []
        for p0 in self.paths:
            base = active.index(p0) if p0 in active else 0
            out.append((p0,) + tuple(active[(base + j) % len(active)]
                                     for j in range(1, self.flowcells)))
        return tuple(out)


def apply_plan(current, candidate) -> tuple[object, bool]:
    """Versioned plan application, the no-reordering rule across plans:
    ``(applied, took_candidate)``.  The candidate replaces the current
    plan only when its ``version`` is higher; a stale (reordered) or
    repeated (duplicated) delivery is refused and the current table stays
    (applying an older table would move chunks already committed to the
    newer one's paths).  A refusal is not an error: the caller counts it."""
    if candidate.version <= current.version:
        return current, False
    return candidate, True


def replan_chunk_paths(paths: tuple[int, ...], directions: tuple[int, ...],
                       inactive: tuple[bool, ...],
                       in_flight: tuple[int, ...] = ()) -> tuple[int, ...]:
    """Mid-collective replan: move chunks off newly quarantined paths onto
    surviving ones without reordering any chunk.  Per chunk:

      * a chunk in ``in_flight`` keeps its path (its packets are already on
        the wire, and a move would race them);
      * a moving chunk goes only to a path of the same ring direction (a
        flip renumbers the segments it has already reduced);
      * with no surviving path of its direction the chunk stays on its
        quarantined path (late but in order).

    Chunks on healthy paths stay; movers spread round-robin over the
    survivors of their direction."""
    if len(directions) != len(inactive):
        raise ValueError("inactive and directions differ in length")
    in_flight_set = set(in_flight)
    survivors: dict[int, list[int]] = {}
    for p, d in enumerate(directions):
        if not inactive[p]:
            survivors.setdefault(d, []).append(p)
    out: list[int] = []
    rr: dict[int, int] = {}
    for c, p in enumerate(paths):
        same_dir = survivors.get(directions[p], [])
        if c in in_flight_set or not inactive[p] or not same_dir:
            out.append(p)
            continue
        k = rr.get(directions[p], 0)
        out.append(same_dir[k % len(same_dir)])
        rr[directions[p]] = k + 1
    return tuple(out)
