"""The multipath plan of a SeqBalance collective, mirroring
``repro.dist.collectives.PathPlan`` in the fields that
``netsim.workloads.collective_trace`` reads: the gradient bucket is cut
into ``n_chunks`` chunks, and each chunk runs its own ring in its path's
direction; quarantined paths are skipped by the round-robin chunk -> path
map, so in-flight chunks never move.

Only the plan is here.  The rest of the module (the ring all-reduce over
``torch.distributed``, in-epoch replanning, wire dtypes, flowcells) comes
with the ``dist/`` slice of the port.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PathPlan:
    """``directions`` holds one ring direction (+1 / -1) per path;
    ``inactive`` flags the paths that congestion feedback quarantined."""

    n_chunks: int = 4
    directions: tuple[int, ...] = (1, -1)
    inactive: tuple[bool, ...] | None = None

    def __post_init__(self):
        if self.n_chunks < 1:
            raise ValueError(f"n_chunks {self.n_chunks} < 1")
        if any(d not in (1, -1) for d in self.directions):
            raise ValueError(f"directions {self.directions} are not all +1 / -1")
        if self.inactive is None:
            object.__setattr__(self, "inactive", (False,) * len(self.directions))
        if len(self.inactive) != len(self.directions):
            raise ValueError("inactive and directions differ in length")

    @property
    def n_paths(self) -> int:
        return len(self.directions)

    def chunk_paths(self) -> tuple[int, ...]:
        """Round-robin chunk -> path assignment over the active paths; with
        every path quarantined, the primary path (traffic must still flow)."""
        active = [p for p, dead in enumerate(self.inactive) if not dead] or [0]
        return tuple(active[c % len(active)] for c in range(self.n_chunks))
