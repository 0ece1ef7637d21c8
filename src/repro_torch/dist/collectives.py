"""The multipath plan of a SeqBalance collective, mirroring
``repro.dist.collectives.PathPlan`` in the fields that
``netsim.workloads.collective_trace`` reads: the gradient bucket is cut
into ``n_chunks`` chunks, and each chunk runs its own ring in its path's
direction; quarantined paths are skipped by the round-robin chunk -> path
map, so in-flight chunks never move.  With ``flowcells > 1`` each chunk is
cut further into token cells sprayed over the active paths (the reordering
the paper's rule avoids), and ``reorder_budget`` is the NIC's out-of-order
absorption in packets, the simulator's ``reorder`` operand.

Only the plan is here.  The rest of the module (the ring all-reduce over
``torch.distributed``, in-epoch replanning, wire dtypes) comes with the
``dist/`` slice of the port.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PathPlan:
    """``directions`` holds one ring direction (+1 / -1) per path;
    ``inactive`` flags the paths that congestion feedback quarantined.
    ``flowcells`` cuts each chunk into that many equal cells round-robined
    over the active paths (``flowcell_paths``); 1 is the classic plan.
    ``reorder_budget`` (packets, >= 0) rides along to the simulator."""

    n_chunks: int = 4
    directions: tuple[int, ...] = (1, -1)
    inactive: tuple[bool, ...] | None = None
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
        if self.flowcells < 1:
            raise ValueError(f"flowcells {self.flowcells} < 1")
        if not self.reorder_budget >= 0.0:
            raise ValueError(f"reorder_budget {self.reorder_budget} < 0")

    @property
    def n_paths(self) -> int:
        return len(self.directions)

    def _active(self) -> list[int]:
        """The paths not quarantined; with every path quarantined, the
        primary path (traffic must still flow)."""
        return [p for p, dead in enumerate(self.inactive) if not dead] or [0]

    def chunk_paths(self) -> tuple[int, ...]:
        """Round-robin chunk -> path assignment over the active paths."""
        active = self._active()
        return tuple(active[c % len(active)] for c in range(self.n_chunks))

    def flowcell_paths(self) -> tuple[tuple[int, ...], ...]:
        """Per-chunk flowcell -> path table: chunk c's cell j rides
        ``active[(c + j) % n_active]``.  Cell 0 keeps the chunk's
        round-robin path, so ``flowcells=1`` is ``chunk_paths`` exactly."""
        active = self._active()
        return tuple(tuple(active[(c + j) % len(active)] for j in range(self.flowcells))
                     for c in range(self.n_chunks))
