"""The ring membership of the network/training co-simulation, mirroring
``repro.dist.cosim.ring_hosts``.  The rest of the module (the multi-epoch
loop that feeds fault campaigns and congestion reports back into the
plan) comes with the ``dist/`` slice of the port."""
from __future__ import annotations


def ring_hosts(topo, n: int) -> list[int]:
    """``n`` ring members striped across leaves (member i on leaf
    i % n_leaf): while n <= n_leaf, ring neighbours sit on different racks,
    so every ring segment crosses the fabric."""
    L, hpl = topo.n_leaf, topo.hosts_per_leaf
    if not 2 <= n <= topo.n_hosts:
        raise ValueError(f"a ring of {n} on {topo.n_hosts} hosts")
    return [(i % L) * hpl + (i // L) for i in range(n)]
